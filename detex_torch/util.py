"""
SQLite persistence of the detection engine's rows, with the standard
library's sqlite3 over plain row lists (the port has no pandas), the key
reader (``readKey``, re-exported from data/keys.py as detex_tpu's util
re-exports it), and the saved objects and tables.

Saved objects and tables are standard-library pickles:

- ``ClusterStream`` and ``SubSpace`` (``write``, ``saveObject``) pickle
  the port's own classes; their state holds no tensor (each becomes a
  ``HostTensor`` of its numpy values) and no open handle, so a pickle
  loads on a machine without a card. ``loadClusters`` / ``loadSubSpace``
  put tensors back on the device the caller names (the card by default).
- The engine's tables (``EventCors_<NET.STA>.pkl``, ``UTCsaves.pkl``) are
  lists of {column: value} row dicts with detex_tpu's column names in its
  order, arrays as numpy arrays; ``readRows`` loads one, and where pandas
  exists ``pandas.DataFrame(rows)`` is detex_tpu's frame.

Every loader unpickles through ``RestrictedUnpickler``, which admits only
the port's classes, numpy, builtins, collections and torch's storage
types. A pickle of the original Detex (classes of ``detex.*``) goes on to
migrate.py, which converts it into the port's objects; one of detex_tpu
or of pandas is refused with NotImplementedError before anything of it
is imported.

Phase picks (``pickPhases`` by hand in streamPick.py's picker,
``autoPickPhases`` by STA/LTA) are written to the pick CSV that
SubSpace.attachPickTimes reads, without pandas; ``readLog`` reads the log
file of detex_torch.setLogger.

Namesake of detex_tpu/util.py's saveSQLite / loadSQLite (reference
util.py:870-931): the same tables (``ss_df``, ``sg_df``), column order,
declared column types (INTEGER for integer columns, REAL for numeric
ones, TEXT for the rest, as detex_tpu derives them from a DataFrame's
dtypes) and values, so a SubSpace.db written by either package reads the
same. NaN values are stored as NULL (SQLite's rule for a NaN double).
"""
from __future__ import annotations

import numbers
import os
import pickle
import sqlite3

import numpy as np
import torch

import detex_torch
from detex_torch.data.keys import readKey, req_columns  # noqa: F401


def _column_type(values):
    """The declared SQLite type of a column holding ``values``, as pandas'
    dtype of that column gives it in detex_tpu: all integers INTEGER,
    numbers (None among them) REAL, anything else TEXT."""
    if all(isinstance(v, numbers.Integral) for v in values):
        return "INTEGER"
    if all(v is None or isinstance(v, numbers.Real) for v in values):
        return "REAL"
    return "TEXT"


def _py(v, kind):
    """A value as sqlite3 binds it in a column of declared type ``kind``:
    numpy scalars as Python numbers (a NaN is stored as NULL), anything
    in a TEXT column as str."""
    if kind == "INTEGER":
        return int(v)
    if kind == "REAL":
        return None if v is None else float(v)
    return str(v)


def saveSQLite(rows, dbPath, tableName, columns):
    """Append ``rows`` (lists in ``columns`` order) to table ``tableName``
    of the SQLite database ``dbPath``, creating the table if needed
    (reference util.py:870-894)."""
    if not rows:
        return
    columns = list(columns)
    kinds = [_column_type([r[i] for r in rows]) for i in range(len(columns))]
    data = [tuple(_py(v, k) for v, k in zip(r, kinds)) for r in rows]
    con = sqlite3.connect(dbPath)
    try:
        cols = ", ".join('"%s" %s' % (c, k) for c, k in zip(columns, kinds))
        con.execute('CREATE TABLE IF NOT EXISTS "%s" (%s)' % (tableName, cols))
        con.executemany('INSERT INTO "%s" (%s) VALUES (%s)'
                        % (tableName, ", ".join('"%s"' % c for c in columns),
                           ", ".join(["?"] * len(columns))), data)
        con.commit()
    finally:
        con.close()


def _number(v):
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
    except (TypeError, ValueError):
        return False
    return int(f) if str(v).strip().lstrip("+-").isdigit() else f


def _numeric(vals):
    """``vals`` as numbers when every non-NULL value is one (or a string
    that parses as one, detex_tpu's convertNumeric), else None: ints when
    all are integers without NULL, else floats with NULL as NaN."""
    got = [_number(v) for v in vals]
    if any(g is False for g in got) or all(g is None for g in got):
        return None
    if all(isinstance(g, int) for g in got):
        return got
    return [float("nan") if g is None else float(g) for g in got]


def _read_sql_column(vals):
    """A column's values as pandas.read_sql types them: NULL is NaN in a
    column of strings or of numbers (numbers with a NULL become floats),
    and stays None in a column of nothing but NULL."""
    present = [v for v in vals if v is not None]
    if not present or len(present) == len(vals):
        return vals
    nan = float("nan")
    if all(isinstance(v, str) for v in present):
        return [nan if v is None else v for v in vals]
    if all(isinstance(v, (int, float)) for v in present):
        return [nan if v is None else float(v) for v in vals]
    return vals


def loadSQLite(dbPath, tableName, sql=None, convertNumeric=True,
               silent=True, columns=False):
    """Read table ``tableName`` (or the result of the query ``sql``) from
    the SQLite database ``dbPath`` (reference util.py:896-931). Returns a
    list of {column: value} dicts in row order, or with ``columns`` a dict
    of column name -> numpy array; None when the database or the table
    does not exist or the query fails (logged unless ``silent``). With
    ``convertNumeric`` every column whose non-NULL values are all numbers
    (or strings that parse as numbers) comes back as numbers, NULL as NaN,
    as detex_tpu's pandas.to_numeric pass converts them."""
    if not os.path.exists(dbPath):
        if not silent:
            detex_torch.log(__name__, "%s does not exist" % dbPath,
                            level="warning")
        return None
    if sql is None:
        sql = 'SELECT * FROM "%s"' % tableName
    con = sqlite3.connect(dbPath)
    try:
        try:
            cur = con.execute(sql)
        except sqlite3.Error:
            if not silent:
                detex_torch.log(__name__, "could not load table %s from %s"
                                % (tableName, dbPath), level="warning")
            return None
        names = [d[0] for d in cur.description]
        data = cur.fetchall()
    finally:
        con.close()
    cols = {n: _read_sql_column([r[i] for r in data])
            for i, n in enumerate(names)}
    if convertNumeric:
        for n, vals in cols.items():
            num = _numeric(vals)
            if num is not None:
                cols[n] = num
    if columns:
        return {n: np.asarray(v) for n, v in cols.items()}
    return [dict(zip(names, r)) for r in zip(*cols.values())] if data \
        else []


# ---------------------------------------------------------------------------
# Saved objects and tables (reference util.py:934-969)
# ---------------------------------------------------------------------------

# modules (and their submodules) a saved object or table may name, and
# the builtins it may name: types only, never a callable such as eval
_ALLOWED_MODULES = ("detex_torch", "numpy", "collections")
_ALLOWED_BUILTINS = {"set", "frozenset", "complex", "slice", "range",
                     "bytearray", "bytes", "list", "dict", "tuple", "int",
                     "float", "bool", "str"}
# torch's own names in a pickle of tensors or storages
_ALLOWED_TORCH = {("torch._utils", "_rebuild_tensor_v2"),
                  ("torch._utils", "_rebuild_tensor"),
                  ("torch.storage", "_load_from_bytes"),
                  ("torch", "device")}


def _under(module, roots):
    return any(module == r or module.startswith(r + ".") for r in roots)


class DetexPickle(NotImplementedError):
    """A pickle that names the original Detex package: the loaders hand
    it to migrate.py."""


class RestrictedUnpickler(pickle.Unpickler):
    """An Unpickler that resolves only the port's classes, numpy, the
    builtin types, collections and torch's storage types; any other name
    raises pickle.UnpicklingError, and nothing is imported for a refused
    name. Three foreign packages raise NotImplementedError instead, each
    saying what holds for it: a name of the original Detex (``detex.*``)
    raises DetexPickle, which loadClusters / loadSubSpace catch to convert
    the pickle with migrate.py; a detex_tpu name is refused (detex_tpu's
    own objects have no conversion, in its migrate.py either); a pandas
    name (a pickled DataFrame, such as detex_tpu's tables) is refused,
    since only migrate reads DataFrames, inside a Detex object."""

    def find_class(self, module, name):
        if _under(module, ("detex",)):
            detex_torch.log(__name__, "%s.%s is a class of the original "
                            "Detex: util.loadClusters / loadSubSpace "
                            "convert its pickles with migrate.py"
                            % (module, name), level="error", e=DetexPickle)
        if _under(module, ("detex_tpu",)):
            detex_torch.log(__name__, "%s.%s is a class of detex_tpu, whose "
                            "pickles the port does not read: migrate.py "
                            "converts only the original Detex's, as "
                            "detex_tpu's migrate does; rebuild the object "
                            "with detex_torch" % (module, name),
                            level="error", e=NotImplementedError)
        if _under(module, ("pandas",)):
            detex_torch.log(__name__, "%s.%s: a pickled pandas object (such "
                            "as a detex_tpu table) is not read here; the "
                            "port's tables are lists of row dicts, and only "
                            "migrate.py reads DataFrames, inside a Detex "
                            "object" % (module, name), level="error",
                            e=NotImplementedError)
        if (module, name) in _ALLOWED_TORCH or \
                (module == "torch" and name.endswith("Storage")) or \
                (module == "builtins" and name in _ALLOWED_BUILTINS):
            return super().find_class(module, name)
        if _under(module, _ALLOWED_MODULES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError("a saved detex_torch object may not "
                                     "name %s.%s" % (module, name))


def _restricted_load(filename):
    with open(filename, "rb") as fh:
        return RestrictedUnpickler(fh).load()


class HostTensor(object):
    """A tensor of a saved object, held as numpy on the host; the loaders
    turn it back into a tensor on their device."""

    def __init__(self, array):
        self.array = array


def host_state(value):
    """``value`` with every tensor inside plain dicts, lists and tuples
    turned into a HostTensor of its values on the host, and every
    torch.device into its name (what a saved object's ``__getstate__``
    returns)."""
    if torch.is_tensor(value):
        return HostTensor(value.detach().cpu().numpy())
    if isinstance(value, torch.device):
        return str(value)
    if type(value) is dict:
        return {k: host_state(v) for k, v in value.items()}
    if type(value) in (list, tuple):
        return type(value)(host_state(v) for v in value)
    return value


def _on_device(value, device, seen):
    """Every HostTensor reachable from ``value`` (through dicts, lists,
    tuples and the attributes of the port's objects) replaced by a tensor
    on ``device``, in place where it can be; returns the value."""
    if isinstance(value, HostTensor):
        return torch.from_numpy(np.asarray(value.array)).to(device)
    if id(value) in seen:
        return value
    if isinstance(value, dict):
        seen.add(id(value))
        for k, v in value.items():
            value[k] = _on_device(v, device, seen)
    elif isinstance(value, list):
        seen.add(id(value))
        for i, v in enumerate(value):
            value[i] = _on_device(v, device, seen)
    elif type(value) is tuple:
        return tuple(_on_device(v, device, seen) for v in value)
    elif type(value).__module__.startswith("detex_torch") and \
            hasattr(value, "__dict__"):
        seen.add(id(value))
        for k, v in vars(value).items():
            setattr(value, k, _on_device(v, device, seen))
        if hasattr(value, "device"):
            value.device = device
    return value


def _load_object(filename, device):
    if torch.device(device).type == "cuda":
        detex_torch.require_cuda()
    try:
        obj = _restricted_load(filename)
    except DetexPickle:
        from detex_torch import migrate
        return migrate.load(filename, device=device)
    return _on_device(obj, device, set())


def loadClusters(filename="clust.pkl", device="cuda"):
    """Load a ClusterStream written by ClusterStream.write or saveObject,
    its tensors (if any) on ``device`` and its ``device`` set to it (the
    card unless the caller asks for "cpu"). A pickle of the original
    Detex is converted by migrate.py; a detex_tpu pickle raises
    NotImplementedError."""
    from detex_torch.subspace import ClusterStream
    obj = _load_object(filename, device)
    if not isinstance(obj, ClusterStream):
        detex_torch.log(__name__, "%s holds a %s, not a ClusterStream"
                        % (filename, type(obj).__name__), level="error",
                        e=TypeError)
    return obj


def loadSubSpace(filename="subspace.pkl", device="cuda"):
    """Load a SubSpace written by SubSpace.write or saveObject, as
    loadClusters loads a ClusterStream."""
    from detex_torch.subspace import SubSpace
    obj = _load_object(filename, device)
    if not isinstance(obj, SubSpace):
        detex_torch.log(__name__, "%s holds a %s, not a SubSpace"
                        % (filename, type(obj).__name__), level="error",
                        e=TypeError)
    return obj


def saveObject(obj, filename):
    """Pickle ``obj`` to ``filename`` (reference util.py:964-969)."""
    with open(filename, "wb") as fh:
        pickle.dump(obj, fh)


def writeRows(rows, filename):
    """Pickle a table, a list of {column: value} row dicts, to
    ``filename``."""
    with open(filename, "wb") as fh:
        pickle.dump(list(rows), fh)


def readRows(path):
    """The list of {column: value} row dicts of a table the engine wrote
    (``EventCors_<NET.STA>.pkl``, ``UTCsaves.pkl``), loaded through
    RestrictedUnpickler."""
    rows = _restricted_load(path)
    if not isinstance(rows, list) or not all(isinstance(r, dict)
                                             for r in rows):
        detex_torch.log(__name__, "%s does not hold a list of row dicts"
                        % path, level="error", e=TypeError)
    return rows


def get_number_channels(st):
    """The number of distinct channels of a one-station Stream (reference
    util.py:992-1002)."""
    if len({tr.stats.station for tr in st}) > 1:
        detex_torch.log(__name__, "function only takes streams with exactly "
                        "1 station", level="error")
    return len({tr.stats.channel for tr in st})


# ---------------------------------------------------------------------------
# Phase picks (reference util.py:1006-1101 and its streamPick.py GUI)
# ---------------------------------------------------------------------------

PICK_COLUMNS = ["TimeStamp", "Station", "Event", "Phase", "Channel",
                "Seconds"]
AUTO_PICK_COLUMNS = ["TimeStamp", "Station", "Event", "Phase"]


def seeWaveFroms(fetch="ContinuousWaveForms", templatekey="TemplateKey.csv",
                 stationkey="StationKey.csv", outFile="PhasePicks.csv",
                 **kwargs):
    """pickPhases over ``fetch``, by default the continuous-data directory
    (what the reference's template browser, util.py:1104-1190, meant to
    do; it shipped reading undefined names)."""
    return pickPhases(fetch=fetch, templatekey=templatekey,
                      stationkey=stationkey, pickFile=outFile, **kwargs)


def pickPhases(fetch="EventWaveForms", templatekey="TemplateKey.csv",
               stationkey="StationKey.csv", pickFile="PhasePicks.csv",
               skipIfExists=True, pickerFactory=None, **kwargs):
    """Pick phases by hand on every station / event stream of the
    template key (reference util.py:1007-1101): each stream opens in
    ``pickerFactory(stream)`` (default streamPick.streamPick: q / a / w /
    s pick P / Pend / S / Send at the cursor, "v" goes on, escape stops);
    the picks are added to ``pickFile`` (columns TimeStamp, Station,
    Event, Phase, Channel, Seconds, sorted by Station then Event), saved
    every 10 events and when the user stops. With ``skipIfExists`` the
    station / event pairs already in the file are not shown again.
    ``pickerFactory`` may be any callable ``stream -> obj`` with
    ``._picks`` and ``.KeepGoing``; kwargs go to quickFetch. Returns the
    file's rows."""
    from detex_torch.data import fetcher as getdata
    from detex_torch.data import keys
    if pickerFactory is None:
        from detex_torch.streamPick import streamPick as pickerFactory
    temkey = readKey(templatekey, key_type="template")
    stakey = readKey(stationkey, key_type="station")
    fetcher = getdata.quickFetch(fetch, **kwargs)
    ets = {}  # station -> events already picked, to skip
    rows = []
    if os.path.exists(pickFile):
        old = keys.read_csv(pickFile)[1]
        if len(old) < 1:
            os.remove(pickFile)
        else:
            rows = old
            if skipIfExists:
                for r in old:
                    ets.setdefault(r["Station"], []).append(r["Event"])

    def _save():
        out = keys.sort_rows(rows, ["Station", "Event"])
        keys.write_csv(pickFile, PICK_COLUMNS, out)
        return out

    count = 0
    for st, event in fetcher.getTemData(temkey, stakey, skipDict=ets,
                                        returnName=True):
        if st is None or len(st) < 1:
            continue
        count += 1
        pks = pickerFactory(st)
        sta = "%s.%s" % (st[0].stats.network, st[0].stats.station)
        for b in pks._picks:
            if not b:
                continue
            tstamp = b["time"].timestamp
            rows.append({"TimeStamp": tstamp, "Station": sta,
                         "Event": event, "Phase": b.phase_hint,
                         "Channel": b["waveform_id"]["channel_code"],
                         "Seconds": "%3.5f" % tstamp})
        if not pks.KeepGoing:
            detex_torch.log(__name__, "Exiting picking GUI, progress saved "
                            "in %s" % pickFile)
            return _save()
        if count % 10 == 0:
            _save()
    return _save()


def autoPickPhases(templateKey="TemplateKey.csv", stationKey="StationKey.csv",
                   fetch="EventWaveForms", fileName="PhasePicks.csv",
                   staTime=0.5, ltaTime=5.0, threshold=3.0,
                   filt=(1, 10, 2, True), tb4=10, taft=120, phase="P"):
    """Pick phases without a window (detex_tpu's extension): for every
    station / event stream, ``tb4`` s before to ``taft`` s after the
    origin, the vertical channel (or the first) bandpassed with ``filt``
    (the host filter, native when built), its classic STA/LTA, and the
    first sample where it reaches ``threshold`` as a ``phase`` pick.
    Written to ``fileName`` with columns TimeStamp, Station, Event, Phase,
    every 10 picks and at the end. Returns the rows."""
    from detex_torch.data import fetcher as getdata
    from detex_torch.data import keys
    from detex_torch.ops.stalta import classic_sta_lta
    temkey = readKey(templateKey, "template")
    stakey = readKey(stationKey, "station")
    fetcher = getdata.quickFetch(fetch)
    rows = []
    for srow in stakey:
        skey = [r for r in stakey if r["STATION"] == srow["STATION"]]
        for st, name in fetcher.getTemData(temkey, skey, tb4, taft,
                                           returnName=True):
            if filt is not None:
                st.filter("bandpass", freqmin=filt[0], freqmax=filt[1],
                          corners=filt[2], zerophase=filt[3])
            stz = st.select(component="Z")
            tr = stz[0] if len(stz) else st[0]
            sr = tr.stats.sampling_rate
            cft = classic_sta_lta(tr.data, staTime * sr, ltaTime * sr)
            above = np.flatnonzero(cft >= threshold)
            if len(above) == 0:
                continue
            rows.append(dict(TimeStamp=tr.stats.starttime.timestamp
                             + above[0] / sr,
                             Station="%s.%s" % (srow["NETWORK"],
                                                srow["STATION"]),
                             Event=name, Phase=phase))
            if len(rows) % 10 == 0:
                keys.write_csv(fileName, AUTO_PICK_COLUMNS, rows)
    keys.write_csv(fileName, AUTO_PICK_COLUMNS, rows)
    return rows


def readLog(logpath="detex_torch.log"):
    """The lines of the log file detex_torch.setLogger writes, as a list
    of {"Time", "Mod", "Level", "Msg"} dicts (reference util.py:972-987;
    a tab inside a message stays in Msg)."""
    rows = []
    with open(logpath) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 4:
                rows.append(dict(zip(("Time", "Mod", "Level", "Msg"),
                                     parts[:3] + ["\t".join(parts[3:])])))
    return rows
