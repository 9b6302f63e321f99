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
types. A pickle of detex_tpu or of the original Detex (classes of
``detex_tpu.*``, ``detex.*`` or ``pandas.*``) is refused with
NotImplementedError before anything of it is imported: converting such
pickles is detex_tpu's migrate.py, not yet ported.

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
_FOREIGN_MODULES = ("detex_tpu", "detex", "pandas")


def _under(module, roots):
    return any(module == r or module.startswith(r + ".") for r in roots)


class RestrictedUnpickler(pickle.Unpickler):
    """An Unpickler that resolves only the port's classes, numpy, the
    builtin types, collections and torch's storage types. detex_tpu, Detex
    and pandas classes raise NotImplementedError (their conversion is the
    migrate module, not yet ported); any other name raises
    pickle.UnpicklingError. Nothing is imported for a refused name."""

    def find_class(self, module, name):
        if _under(module, _FOREIGN_MODULES):
            detex_torch.log(__name__, "%s.%s is a class of detex_tpu, Detex "
                            "or pandas: converting their pickles is "
                            "detex_tpu's migrate.py, which is not ported "
                            "yet (ROADMAP A20)" % (module, name),
                            level="error", e=NotImplementedError)
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
    return _on_device(_restricted_load(filename), device, set())


def loadClusters(filename="clust.pkl", device="cuda"):
    """Load a ClusterStream written by ClusterStream.write or saveObject,
    its tensors (if any) on ``device`` and its ``device`` set to it (the
    card unless the caller asks for "cpu"). A detex_tpu or Detex pickle
    raises NotImplementedError."""
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
