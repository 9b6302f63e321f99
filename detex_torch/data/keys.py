"""
Key-file (CSV "keys") reading and validation, with the standard library's
csv module over rows (the port has no pandas).

Namesake of detex_tpu/data/keys.py (reference util.py:563-696): template,
station and phases keys with required-column validation, the blank-row
filter and the sort. detex_tpu reads a key with ``pandas.read_csv``;
``read_csv`` here gives the same values:

- each column's type is inferred as pandas infers it: all integers (after
  an optional sign and surrounding spaces, so "0042" is 42) give ints, all
  numbers give floats, all of True / False give bools, anything else
  strings;
- a cell in pandas' default NA list (the empty cell among them) is NaN, in
  any column, never "" (so an int column with an empty cell is a float
  column);
- floats are parsed digit by digit as pandas' default ("high" precision)
  parser does, which can land one unit in the last place away from
  Python's float() on long decimals such as pick times near 1.2e9 s.

Rows are dicts keyed by column name, in the file's column order.
"""
from __future__ import annotations

import csv
import math
import numbers
import os
import re

import numpy as np

import detex_torch

# required key columns (reference util.py:566-571)
req_temkey = set(["TIME", "NAME", "LAT", "LON", "MAG", "DEPTH"])
req_stakey = set(["NETWORK", "STATION", "STARTTIME", "ENDTIME", "LAT",
                  "LON", "ELEVATION", "CHANNELS"])
req_phases = set(["TimeStamp", "Event", "Station", "Phase"])
req_columns = {"template": req_temkey, "station": req_stakey,
               "phases": req_phases}

# pandas' default missing-value strings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INF = {"inf": math.inf, "+inf": math.inf, "infinity": math.inf,
        "+infinity": math.inf, "-inf": -math.inf, "-infinity": -math.inf}
_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")
_INT64 = (-2 ** 63, 2 ** 63 - 1)
_FLOAT_RE = re.compile(r"^\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d*))?\s*$")
# the powers of ten of pandas' parser, as C double literals round them
_POW10 = [float("1e%d" % k) for k in range(309)]


def parse_float(word):
    """``word`` as pandas' default float converter reads it (the "high"
    precision xstrtod of pandas' C tokenizer): the first 17 significant
    digits accumulated in a double, then one multiply or divide by a power
    of ten. None if it is not a number."""
    m = _FLOAT_RE.match(word)
    if m is None:
        return _INF.get(word.strip().lower())
    sign, ipart, fpart, epart = m.groups()
    fpart = fpart or ""
    if not ipart and not fpart:
        return None
    number = 0.0
    exponent = 0
    ndig = 0
    for ch in ipart:
        if ndig < 17:
            number = number * 10.0 + (ord(ch) - 48)
            ndig += 1
        else:
            exponent += 1
    nd = 0
    for ch in fpart:
        if ndig >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        ndig += 1
        nd += 1
    exponent -= nd
    if sign == "-":
        number = -number
    if epart is not None:
        esign = -1 if epart.startswith("-") else 1
        digits = epart.lstrip("+-")
        if not digits:
            return None
        exponent += esign * int(digits[:17])
    if exponent > 308:
        return None
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0 * number
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _infer(words):
    """One column's cells as pandas' C parser types them: ints, else
    floats, else bools, else strings; NA cells are NaN."""
    na = [w in NA_VALUES for w in words]
    vals = [w for w, n in zip(words, na) if not n]
    nan = float("nan")
    if not any(na) and vals and all(_INT_RE.match(w) for w in vals):
        ints = [int(w) for w in vals]
        if all(_INT64[0] <= v <= _INT64[1] for v in ints):
            return ints
    floats = [parse_float(w) for w in vals]
    if all(f is not None for f in floats):
        it = iter(floats)
        return [nan if n else next(it) for n in na]
    if not any(na) and all(w in _TRUE or w in _FALSE for w in vals):
        return [w in _TRUE for w in words]
    return [nan if n else w for w, n in zip(words, na)]


def read_csv(path):
    """(columns, rows) of a CSV file with a header line, each row a
    {column: value} dict with values typed as pandas.read_csv types
    them. Blank lines are skipped; a short line's missing cells are
    NaN."""
    with open(path, newline="") as fh:
        lines = [r for r in csv.reader(fh) if r]
    if not lines:
        detex_torch.log(__name__, "%s has no header line" % path,
                        level="error")
    columns, body = lines[0], lines[1:]
    width = len(columns)
    for r in body:
        if len(r) > width:
            detex_torch.log(__name__, "%s: a line has %d fields, the header "
                            "%d" % (path, len(r), width), level="error")
    cols = [_infer([r[i] if i < len(r) else "" for r in body])
            for i in range(width)]
    return columns, [dict(zip(columns, vals)) for vals in zip(*cols)] \
        if body else []


def _cell(v, as_float=False):
    """A value as pandas' to_csv writes it: floats as repr, NaN as an
    empty cell, ints of a column pandas holds as floats as floats."""
    if isinstance(v, (float, np.floating)):
        return "" if v != v else repr(float(v))
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return repr(float(v)) if as_float else str(int(v))
    return str(v)


def write_csv(path, columns, rows):
    """Write ``rows`` ({column: value} dicts, NaN where a row lacks a
    column) under a ``columns`` header as pandas'
    ``DataFrame.to_csv(path, index=False)`` writes them ("\\n" line ends,
    minimal quoting); a column of ints and floats is a float column."""
    nan = float("nan")
    table = [[r.get(c, nan) for c in columns] for r in rows]
    as_float = []
    for i in range(len(columns)):
        vals = [t[i] for t in table]
        nums = [v for v in vals if isinstance(v, numbers.Number)
                and not isinstance(v, bool)]
        as_float.append(len(nums) == len(vals) and any(
            isinstance(v, (float, np.floating)) for v in nums))
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow(columns)
        for t in table:
            w.writerow([_cell(v, f) for v, f in zip(t, as_float)])


def _isna(v):
    return v is None or (isinstance(v, float) and v != v)


def rank_codes(values):
    """Per value its rank among the distinct non-missing values, missing
    values ranked last: the codes of pandas' ordered Categorical, which
    its multi-column sorts lexsort."""
    present = sorted({v for v in values if not _isna(v)})
    rank = {v: i for i, v in enumerate(present)}
    return np.array([len(present) if _isna(v) else rank[v] for v in values],
                    dtype=np.int64)


def sort_rows(rows, by):
    """``rows`` in the order of pandas' ``DataFrame.sort_values(by)``: a
    list of columns is a stable lexsort of their rank codes; one column is
    numpy's (non-stable) quicksort argsort of its numeric values with
    missing ones last, or a stable sort of a string column (pandas sorts
    its string columns with pyarrow's stable sort)."""
    if not rows:
        return []
    if isinstance(by, (list, tuple)) and len(by) == 1:
        by = by[0]
    if isinstance(by, (list, tuple)):
        codes = [rank_codes([r[c] for r in rows]) for c in by]
        order = np.lexsort(codes[::-1])
    else:
        vals = [r[by] for r in rows]
        miss = np.array([_isna(v) for v in vals])
        idx = np.arange(len(vals))
        kept = [v for v, m in zip(vals, miss) if not m]
        if all(isinstance(v, str) for v in kept):
            sub = sorted(range(len(kept)), key=kept.__getitem__)
        else:
            sub = np.asarray(kept, dtype=np.float64).argsort(kind="quicksort")
        order = np.concatenate([idx[~miss][np.asarray(sub, dtype=np.int64)],
                                idx[miss]])
    return [rows[i] for i in order]


def readKey(dfkey, key_type="template"):
    """Read a key CSV (or take its rows) and validate the required columns
    (reference util.py:574-627): rows with an empty string in a required
    column are dropped (a pandas-read empty cell is NaN, not "", so none
    are in practice), the rows are sorted by the required columns in
    sorted name order, and a station key's NETWORK and STATION become
    strings ("0042" read as the int 42 becomes "42"). Returns a list of
    row dicts."""
    key_types = list(req_columns.keys())
    if key_type not in key_types:
        detex_torch.log(__name__, "unsupported key type, supported types "
                        "are %s" % key_types, level="error")
    if isinstance(dfkey, (str, os.PathLike)):
        if not os.path.exists(dfkey):
            detex_torch.log(__name__, "%s does not exist, check path"
                            % dfkey, level="error")
        columns, rows = read_csv(dfkey)
    elif isinstance(dfkey, (list, tuple)):
        rows = [dict(r) for r in dfkey]
        columns = list(rows[0]) if rows else sorted(req_columns[key_type])
    else:
        detex_torch.log(__name__, "Data type of dfkey not understood",
                        level="error")
    req = sorted(req_columns[key_type])
    if not req_columns[key_type].issubset(columns):
        detex_torch.log(__name__, "Required columns not in %s, required "
                        "columns for %s key are %s"
                        % (list(columns), key_type, req), level="error")
    rows = [r for r in rows if all(r[c] != "" for c in req)]
    rows = sort_rows(rows, req)
    if key_type == "station":
        for r in rows:
            r["STATION"] = str(r["STATION"])
            r["NETWORK"] = str(r["NETWORK"])
    return rows
