"""
The window as one detect.detex call per detector kind, whose chunk
iterator hands out chunks (0, 0), (0, 1), ... through the passes of the
span and stops once the call's share of --seconds has passed (the kinds
and stations in turn). The bank build falls in the window. The warm-up is
one call per kind on two batches and one chunk more a station, from the
warm-up's pass.

The check: chunks the seed draws among those handed, ``event_chunks`` of
them holding a planted event and ``random_chunks`` more, each against
its planted detectors, every detector that wrote a row there and
``random_detectors`` more; histograms over every handed chunk of one
detector a block of ``hist_block_rows`` detectors the seed draws (the
last block the one the bank pads).
"""
from __future__ import annotations

import itertools
import os
import time

from portbench.harness import gen as _gen

KEYS = ()
CHECK_KEYS = ("handed_chunks", "event_chunks", "random_chunks",
              "random_detectors", "hist_block_rows")


def _keys(cell, first_pass=0):
    for p in itertools.count(first_pass):
        for c in range(cell.span_chunks):
            yield (p, c)


def warmup(run):
    cell = run.cell
    n = 2 * int(run.cfg["batch_size"]) + 1
    db = os.path.join(run.workdir, "warmup.db")
    for kind in cell.kinds:
        call = dict(kind=kind, db=db, hist=None, handed={})
        run.detex(kind, run.chunks(
            call, lambda name: itertools.islice(_keys(cell, -1), n),
            limit=n), db)


def window(run):
    cell = run.cell
    S = len(run.stations)
    K = len(cell.kinds)
    t0 = time.perf_counter()
    db = os.path.join(run.workdir, "window.db")
    for ki, kind in enumerate(cell.kinds):
        call = dict(kind=kind, db=db, hist=None, handed={})
        ends = {st.name: t0 + (ki * S + si + 1) * run.seconds / (K * S)
                for si, st in enumerate(run.stations)}

        def chunks(name, call=call, ends=ends, ki=ki):
            return run.chunks(call, lambda n: _keys(cell), stop_at=ends[name],
                              capture=ki == 0)(name)
        call["hist"] = run.detex(kind, chunks, db)
        run.calls.append(call)
    run.passes = max(len(v) for c in run.calls
                     for v in c["handed"].values()) // cell.span_chunks


def capture_candidates(run):
    """The chunks the handed samples may be drawn from: the first 8."""
    return [(st.name, (0, c)) for st in run.stations for c in range(8)]


def plan(run, rng):
    cell = run.cell
    tr = cell.traffic["check"]
    row_units, hist_units = {}, {}
    for ci, call in enumerate(run.calls):
        for sta, keys in call["handed"].items():
            dets = run.dets_of(call["kind"], sta)
            st = run.station(sta)
            with_ev = [i for i, k in enumerate(keys) if _gen.events_in(
                cell, st, *cell.chunk(k)[:2])]
            pick = list(rng.choice(with_ev, min(len(with_ev),
                                                tr["event_chunks"]),
                                   replace=False)) if with_ev else []
            rest = sorted(set(range(len(keys))) - set(pick))
            pick += list(rng.choice(rest, min(len(rest),
                                              tr["random_chunks"]),
                                    replace=False)) if rest else []
            for i in pick:
                start, L, _ = cell.chunk(keys[i])
                names = {dets[j]["name"] for k, j in
                         _gen.events_in(cell, st, start, L)
                         if k == call["kind"]}
                names |= {dets[j]["name"] for j in rng.choice(
                    len(dets), min(len(dets), tr["random_detectors"]),
                    replace=False)}
                row_units.setdefault((sta, keys[i]), {})[ci] = sorted(names)
            B = int(tr["hist_block_rows"])
            hist = [dets[int(rng.integers(b, min(b + B, len(dets))))]["name"]
                    for b in range(0, len(dets), B)]
            hist_units[(ci, sta)] = (list(keys), hist)
    return row_units, hist_units
