"""
The window in whole passes: each pass runs detect.detex once per detector
kind (subspaces, then single templates) over the span of every station,
into a database of its own, until --seconds have passed. The warm-up is
one call per kind on a batch and one chunk more a station (a padded
second batch).

The check: every chunk of one pass the seed draws, and of every other pass
that scans the same samples (an archive's passes re-read the same files),
with every detector's rows and histograms.
"""
from __future__ import annotations

import os
import time

KEYS = ()
CHECK_KEYS = ("handed_chunks",)


def keys_of(cell, p):
    return [(p, c) for c in range(cell.span_chunks)]


def _pass(run, p, db, limit=None, record=True):
    for i, kind in enumerate(run.cell.kinds):
        call = dict(kind=kind, db=db, hist=None, handed={}, p=p)
        call["hist"] = run.detex(kind, run.chunks(
            call, lambda name: keys_of(run.cell, p), limit=limit,
            capture=record and p == 0 and i == 0), db)
        if record:
            run.calls.append(call)


def warmup(run):
    _pass(run, -1, os.path.join(run.workdir, "warmup.db"),
          limit=int(run.cfg["batch_size"]) + 1, record=False)


def window(run):
    t0 = time.perf_counter()
    while True:
        _pass(run, run.passes, os.path.join(run.workdir,
                                            "pass_%d.db" % run.passes))
        run.passes += 1
        if time.perf_counter() - t0 >= run.seconds:
            break


def capture_candidates(run):
    """The chunks the handed samples may be drawn from: the first pass's."""
    return [(st.name, k) for st in run.stations
            for k in keys_of(run.cell, 0)]


def plan(run, rng):
    """({(sta, key): {call index: detector names}},
    {(call index, sta): (keys, detector names)})."""
    cell = run.cell
    p = int(rng.integers(0, run.passes))
    drawn = {cell.chunk(k)[:2] for k in keys_of(cell, p)}
    row_units, hist_units = {}, {}
    for ci, call in enumerate(run.calls):
        if any(cell.chunk(k)[:2] not in drawn
               for keys in call["handed"].values() for k in keys):
            continue
        for sta, keys in call["handed"].items():
            names = [d["name"] for d in run.dets_of(call["kind"], sta)]
            for key in keys:
                row_units.setdefault((sta, key), {})[ci] = names
            hist_units[(ci, sta)] = (list(keys), names)
    return row_units, hist_units
