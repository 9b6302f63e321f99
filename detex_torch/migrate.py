"""
Pickles of the original Detex package (ClusterStream / SubSpace objects
with class paths ``detex.subspace.*`` and their ``detex.getdata``
DataFetcher; reference subspace.py:261-267, 2018-2026, util.py:934-969)
turned into the port's ClusterStream, Cluster and SubSpace.
util.loadClusters / loadSubSpace hand such a pickle here.

Namesake of detex_tpu/migrate.py. The pickle is read by a restricted
unpickler: every ``detex.*`` class becomes an inert shell (an attribute
bucket) and every ``detex.*`` function a placeholder that raises when
called; pandas, the pyarrow reconstructors that pandas' pickles name,
numpy, builtin types, collections, ``copyreg._reconstructor`` and
``_codecs.encode`` are admitted; any other name raises
pickle.UnpicklingError, and a detex_tpu name NotImplementedError.
Python 2 byte strings are read as latin-1.

A Detex object holds pandas DataFrames (whose string columns pickle as
pyarrow arrays with pandas 3), so this is the one module of the port
that uses pandas: unpickling imports it when the pickle names it, and
every DataFrame becomes the port's rows at once (a list of {column:
value} dicts; CC, lag and subsample frames square [m, m] numpy arrays).
Fields the port's rows hold and a Detex row may lack are rebuilt:
templates from the template key, the raw template streams through the
rebuilt fetcher, and a row's SVDdefined, NumBasis, SampleTrims, offsets
and Offsets, so that a migrated SubSpace runs ``detex`` as it is. A
directory fetcher is rebuilt when its directory exists here, else it is
None with a warning (set ``.fetcher`` / ``.cfetcher`` before fetching).
"""
from __future__ import annotations

import _compat_pickle
import pickle

import numpy as np

import detex_torch


class _Shell(object):
    """Attribute bucket standing in for a class of the original Detex."""


class _ShellClusterStream(_Shell):
    pass


class _ShellCluster(_Shell):
    pass


class _ShellSubSpace(_Shell):
    pass


class _ShellDataFetcher(_Shell):
    pass


def _placeholder(*_a, **_k):
    raise NotImplementedError(
        "a function of the original detex package was called on a "
        "migrated object; migrate converts the objects that hold it")


_CLASS_MAP = {
    ("detex.subspace", "ClusterStream"): _ShellClusterStream,
    ("detex.subspace", "Cluster"): _ShellCluster,
    ("detex.subspace", "SubSpace"): _ShellSubSpace,
    ("detex.getdata", "DataFetcher"): _ShellDataFetcher,
}
# modules (with their submodules) whose names a Detex pickle may hold
_ADMITTED_MODULES = ("pandas", "numpy", "collections")
# the pyarrow reconstructors of pandas' pickled string arrays
_PYARROW = {"_restore_array", "type_for_alias", "py_buffer"}
_ADMITTED = {("copyreg", "_reconstructor"), ("_codecs", "encode")}
_BUILTIN_TYPES = {"set", "frozenset", "complex", "slice", "range",
                  "bytearray", "bytes", "list", "dict", "tuple", "int",
                  "float", "bool", "str", "object"}


def _under(module, roots):
    return any(module == r or module.startswith(r + ".") for r in roots)


class _DetexUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        key = (module, name)
        if key in _CLASS_MAP:
            return _CLASS_MAP[key]
        if _under(module, ("detex",)):
            return _Shell if name[:1].isupper() else _placeholder
        if _under(module, ("detex_tpu",)):
            detex_torch.log(__name__, "%s.%s is a class of detex_tpu: "
                            "migrate converts only the original Detex's "
                            "pickles" % key, level="error",
                            e=NotImplementedError)
        # a protocol 2 pickle names Python 2's modules (__builtin__,
        # copy_reg), which the base find_class maps to Python 3's
        mod, nm = _compat_pickle.NAME_MAPPING.get(
            key, (_compat_pickle.IMPORT_MAPPING.get(module, module), name))
        if _under(mod, _ADMITTED_MODULES) or (mod, nm) in _ADMITTED or \
                (mod == "pyarrow.lib" and nm in _PYARROW) or \
                (mod == "builtins" and nm in _BUILTIN_TYPES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError("a Detex pickle may not name %s.%s"
                                     % key)


def load_reference_pickle(path):
    """The pickle at ``path`` read into shells, unconverted."""
    with open(path, "rb") as fh:
        return _DetexUnpickler(fh, encoding="latin1").load()


# ---------------------------------------------------------------------------
# DataFrames into rows
# ---------------------------------------------------------------------------


def _is_frame(x):
    return type(x).__module__.split(".")[0] == "pandas" and \
        hasattr(x, "columns")


def _rows(df):
    """A DataFrame's rows as {column: value} dicts (rows already given
    pass through)."""
    if df is None:
        return None
    if not _is_frame(df):
        return [dict(r) for r in df]
    cols = [str(c) for c in df.columns]
    return [dict(zip(cols, vals)) for vals in
            df.astype(object).itertuples(index=False, name=None)]


def _square(m, value, fill):
    """The [m, m] upper-triangle matrix of a reference-style pair frame
    (index 0..m-2, columns 1..m-1), or of a square array."""
    if not _is_frame(value):
        return np.asarray(value, np.float64)
    out = np.full((m, m), fill)
    out[:m - 1, 1:] = np.asarray(value.values, dtype=np.float64)
    return out


# ---------------------------------------------------------------------------
# shells into the port's objects
# ---------------------------------------------------------------------------


def _convert_fetcher(shell):
    """A 'dir' DataFetcher with the shell's settings, or None (with a
    warning) when it cannot be rebuilt here."""
    if not isinstance(shell, _Shell):
        return shell
    from detex_torch.data.fetcher import DataFetcher
    method = getattr(shell, "method", "dir")
    kwargs = {a: getattr(shell, a) for a in (
        "removeResponse", "directoryName", "opType", "prefilt",
        "conDatDuration", "conBuff", "timeBeforeOrigin", "timeAfterOrigin",
        "checkData", "fillZeros") if hasattr(shell, a)}
    try:
        return DataFetcher(method, **kwargs)
    except (detex_torch.DetexError, NotImplementedError, OSError):
        detex_torch.log(__name__, "could not rebuild the pickled DataFetcher "
                        "(method=%s, directoryName=%s); set .fetcher / "
                        ".cfetcher before fetching data"
                        % (method, kwargs.get("directoryName")),
                        level="warning")
        return None


def _trdf_row(r):
    """A ClusterStream station row with square CC, lag and subsample
    matrices."""
    r = dict(r, Events=list(r["Events"]))
    m = len(r["Events"])
    for col, fill in (("CCs", np.nan), ("Lags", 0.0), ("Subsamp", np.nan)):
        if r.get(col) is not None:
            r[col] = _square(m, r[col], fill)
    if r.get("Link") is not None:
        r["Link"] = np.asarray(r["Link"], dtype=np.float64)
    return r


def _need(shell, attr, what):
    if not hasattr(shell, attr):
        detex_torch.log(__name__, "the Detex %s pickle has no %r: migrate "
                        "converts only whole ClusterStream and SubSpace "
                        "objects" % (what, attr), level="error",
                        e=NotImplementedError)
    return getattr(shell, attr)


def convert_clusterstream(shell, device="cuda"):
    """A Detex ClusterStream shell as the port's ClusterStream on
    ``device``; each station keeps its cluster's ccReq."""
    from detex_torch.construct import _fetchTemplates
    from detex_torch.subspace import ClusterStream
    trdf = [_trdf_row(r) for r in _rows(_need(shell, "trdf",
                                              "ClusterStream"))]
    shells = {c.station: c for c in _need(shell, "clusters",
                                          "ClusterStream")}
    temkey = _rows(getattr(shell, "temkey", None))
    stakey = _rows(getattr(shell, "stakey", None))
    fetcher = _convert_fetcher(getattr(shell, "fetcher", None))
    trim = getattr(shell, "trim", None)
    filt = getattr(shell, "filt", None)
    templates, streams = {}, None
    for r in temkey or []:
        templates.setdefault(r["NAME"], {"time": r["TIME"],
                                         "mag": r["MAG"]})
    if fetcher is not None and temkey and stakey and trim is not None:
        streams = _fetchTemplates(fetcher, stakey, temkey, trim, None)[0]
    eventList = getattr(shell, "eventList", None)
    if eventList is None:
        eventList = sorted({e for r in trdf for e in r["Events"]})
    ccreq = float(shells[trdf[0]["Station"]].ccReq)
    cs = ClusterStream(
        trdf, templates, streams, list(eventList), ccreq,
        list(filt) if filt is not None else None,
        getattr(shell, "decimate", None),
        list(trim) if trim is not None else None,
        bool(getattr(shell, "eventsOnAllStations", False)),
        bool(getattr(shell, "enforceOrigin", False)), device, temkey=temkey,
        stakey=stakey, fetcher=fetcher,
        fileName=getattr(shell, "filename",
                         getattr(shell, "fileName", "clust.pkl")))
    for cl in cs.clusters:
        c = shells[cl.station]
        cl.link = np.asarray(c.link, dtype=np.float64)
        cl.key = list(c.key)
        cl.updateReqCC(float(c.ccReq))
    return cs


def _detector_row(r, defaults):
    """A Detex subspace or single row with the fields the port's rows
    hold: ``defaults`` for a missing column, Events a list, SVDdefined
    and NumBasis from the SVD, and each event's offset from its start
    and origin times."""
    row = dict(defaults, **r)
    row["Events"] = list(row["Events"])
    if not isinstance(row["SampleTrims"], dict):
        row["SampleTrims"] = {}
    if "SVD" in defaults:
        if "SVDdefined" not in r:
            row["SVDdefined"] = isinstance(row["SVD"], dict)
        if "NumBasis" not in r and row["UsedSVDKeys"] is not None:
            row["NumBasis"] = len(row["UsedSVDKeys"])
    for st in row["Stats"].values():
        if "offset" not in st and "origintime" in st:
            st["offset"] = st["starttime"] - st["origintime"]
    return row


def convert_subspace(shell, device="cuda"):
    """A Detex SubSpace shell as the port's SubSpace on ``device``."""
    from detex_torch.construct import _row_defaults
    from detex_torch.subspace import SubSpace
    cl = _need(shell, "clusters", "SubSpace")
    clusters = convert_clusterstream(cl, device) \
        if isinstance(cl, _ShellClusterStream) else cl
    cfetcher = _convert_fetcher(getattr(shell, "cfetcher", None))
    raw_fetcher = getattr(shell, "cfetcher", None)
    ss_defaults = _row_defaults()
    sg_defaults = dict(SampleTrims={}, FAS=None, Threshold=np.nan,
                       Offsets=None)
    subspaces = {sta: [_detector_row(r, ss_defaults) for r in _rows(df)]
                 for sta, df in (_need(shell, "subspaces", "SubSpace")
                                 or {}).items()}
    singles = {sta: [_detector_row(r, sg_defaults) for r in _rows(df)]
               for sta, df in (getattr(shell, "singles", None)
                               or {}).items()}
    ss = SubSpace(singles, subspaces, clusters,
                  getattr(shell, "dtype", "double"),
                  getattr(shell, "Pf", 1e-12),
                  getattr(raw_fetcher, "conDatDuration", 3600.0),
                  getattr(raw_fetcher, "conBuff", 120.0), device,
                  cfetcher=cfetcher)
    if any(r["Offsets"] is None for rows in (*subspaces.values(),
                                             *singles.values())
           for r in rows):
        ss._updateOffsets()
    return ss


def convert(obj, device="cuda"):
    """The port's counterpart of a shell read from a Detex pickle."""
    if isinstance(obj, _ShellClusterStream):
        detex_torch.log(__name__, "migrating an original Detex "
                        "ClusterStream pickle")
        return convert_clusterstream(obj, device)
    if isinstance(obj, _ShellSubSpace):
        detex_torch.log(__name__, "migrating an original Detex SubSpace "
                        "pickle")
        return convert_subspace(obj, device)
    detex_torch.log(__name__, "migrate converts Detex ClusterStream and "
                    "SubSpace pickles, not a %s" % type(obj).__name__,
                    level="error", e=NotImplementedError)


def load(path, device="cuda"):
    """Read and convert the Detex pickle at ``path``; the objects'
    device is ``device`` (the card unless "cpu")."""
    return convert(load_reference_pickle(path), device)
