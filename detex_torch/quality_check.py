"""
Quality audit of an indexed waveform directory: per-file gap, duration
and channel statistics, the files that fail, and optionally their move
out of the directory.

Namesake of detex_tpu/quality_check.py (which completes the reference's
unfinished detex/quality_check.py) on the port's index (data/fetcher.py:
``indexDirectory``, the ``.index.db`` tables, ``_decodePath``), with rows
instead of a DataFrame: the same columns in the same order and the same
rules as detex_tpu's pandas expressions give them. The channel count a
file must have, without ``expected_nc``, is the smallest of the most
frequent counts (``Series.mode``), and a file of zero duration fails the
gap check (its gap ratio is NaN, which counts as 1).
"""
from __future__ import annotations

import os
import shutil
from collections import Counter

import numpy as np

import detex_torch
from detex_torch import util
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import fetcher as getdata

CHECK_COLUMNS = ["duration_ok", "gaps_ok", "nc_ok", "ok"]


def check_data_quality(directory=getdata.conDirDefault, min_duration=0.9,
                       max_gap_ratio=0.1, expected_nc=None,
                       move_bad=False, badDir=None, reindex=False):
    """Audit every file of an indexed waveform directory (detex_tpu
    quality_check.py:18-83).

    A file passes when it spans at least ``min_duration`` of the median
    file duration, its total gap time is at most ``max_gap_ratio`` of its
    duration, and it has ``expected_nc`` channels (default: the most
    frequent count). With ``move_bad`` the failing files move to
    ``badDir`` (default ``<directory>_bad``) and the directory is indexed
    again; ``reindex`` indexes it before the audit.

    Returns one {column: value} row per indexed file: the index's columns
    (Path decoded, FileName, Starttime, Endtime, Gaps, Nc, Nt, Duration,
    Station) and the booleans duration_ok, gaps_ok, nc_ok and ok."""
    dbPath = os.path.join(directory, ".index.db")
    if reindex or not os.path.exists(dbPath):
        getdata.indexDirectory(directory)
    rows = util.loadSQLite(dbPath, "ind")
    if not rows:
        detex_torch.log(__name__, "no indexed files in %s" % directory,
                        level="error")
    key = util.loadSQLite(dbPath, "indkey", convertNumeric=False)
    order = sorted(key[0], key=lambda c: int(str(c).split("_")[1]))
    vocab = [[r[c] for c in order] for r in key]
    med_dur = float(np.median([r["Duration"] for r in rows]))
    if expected_nc is None:
        counts = Counter(r["Nc"] for r in rows)
        top = max(counts.values())
        expected_nc = int(min(n for n, c in counts.items() if c == top))
    for r in rows:
        r["Path"] = getdata._decodePath(r["Path"], vocab)
        r["duration_ok"] = bool(r["Duration"] >= min_duration * med_dur)
        ratio = r["Gaps"] / r["Duration"] if r["Duration"] != 0 else 1.0
        r["gaps_ok"] = bool(ratio <= max_gap_ratio)
        r["nc_ok"] = bool(r["Nc"] == expected_nc)
        r["ok"] = r["duration_ok"] and r["gaps_ok"] and r["nc_ok"]
    bad = [r for r in rows if not r["ok"]]
    detex_torch.log(__name__, "%d of %d files fail quality checks in %s"
                    % (len(bad), len(rows), directory))
    if move_bad and bad:
        badDir = badDir or (directory.rstrip(os.sep) + "_bad")
        os.makedirs(badDir, exist_ok=True)
        for r in bad:
            src = os.path.join(r["Path"], r["FileName"])
            if os.path.exists(src):
                shutil.move(src, os.path.join(badDir, r["FileName"]))
        getdata.indexDirectory(directory)
    return rows


def checkQuality(stPath):
    """Quality stats of one waveform file (gaps, duration, channels), or
    None if it cannot be read (detex_tpu quality_check.py:86-89)."""
    return getdata._checkQuality(stPath)


def divideIntoHours(utc1, utc2):
    """The hour boundaries from utc1 to utc2 as UTCDateTimes (detex_tpu
    quality_check.py:92-96)."""
    return getdata._divideIntoChunks(UTCDateTime(utc1), UTCDateTime(utc2),
                                     3600, None)
