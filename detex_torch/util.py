"""
SQLite persistence of the detection engine's rows, with the standard
library's sqlite3 over plain row lists (the port has no pandas), and the
key reader (``readKey``, re-exported from data/keys.py as detex_tpu's util
re-exports it).

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
import sqlite3

import numpy as np

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
