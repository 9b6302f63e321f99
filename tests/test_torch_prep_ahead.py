"""The batched engine prepares its chunks one batch ahead on a worker
thread (detect._prepWorker): held against the same engine with the prep
run inline on the engine's thread, on a tiny CPU run of two stations of
seven chunks in batches of three, with and without devicePrep, a chunk
too short to use, an empty Stream and a chunk whose filter fails.

The rows, their order in SQLite and the histograms are the same bit for
bit whether the worker or the engine sets the pace; the caller's iterator
is drawn on the calling thread only; prep.ahead + prep.waited counts every
prepared chunk; a batch in flight materializes while the engine would wait
for a prep; the worker makes no torch call; and an error of the
iterator, of a chunk's prep or of a dispatch propagates with no thread
left behind.
"""
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import detex_torch
from detex_torch import detect as tdetect
from detex_torch import trace
from detex_torch import util as tutil
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace

SR = 25.0
L = 10000            # samples a channel: 400 s
N_CHUNKS = 7         # not a multiple of BATCH
BATCH = 3
SHORT, EMPTY, FAILS = ("XX.S1", 2), ("XX.S1", 4), ("XX.S2", 1)
STARTS = {b: 1e9 + 400.0 * b for b in range(N_CHUNKS)}
PACES = {"slow-prep": (0.03, 0.0), "slow-draw": (0.0, 0.03)}
GUARDED = {torch: ("as_tensor", "from_numpy", "tensor", "empty", "zeros",
                   "stack"),
           torch.cuda: ("synchronize", "is_available", "current_stream",
                        "current_device")}


class _Inline(object):
    """The worker seam with every prep run at once on the engine's
    thread."""

    def submit(self, fn, *args):
        fut = Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:
            fut.set_exception(e)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def _inputs(seed=5):
    """Two stations sharing two detectors of 600 multiplexed samples,
    events of the first in chunks 1, 3 and 6."""
    rng = np.random.default_rng(seed)
    dets = []
    for k in range(2):
        u = rng.standard_normal(600)
        U = (u / np.linalg.norm(u))[None]
        dets.append(dict(name="d%d" % k, U=U, WFs=3.0 * U, mags=[1.0],
                         events=["e%d" % k], offsets=[0.0], threshold=0.3))
    X = {}
    for s, sta in enumerate(("XX.S1", "XX.S2")):
        x = rng.standard_normal((N_CHUNKS, 3 * L))
        for b, at in ((1, 2000 + 500 * s), (3, 6000), (6, 3000)):
            x[b, 3 * at:3 * at + 600] += 150.0 * dets[0]["U"][0]
        X[sta] = x
    stations = {sta: dict(channels=["BHE", "BHN", "BHZ"], sr=SR,
                          detectors=dets) for sta in X}
    return stations, X


def _run(db, devicePrep, pace=None, inline=False):
    """One detect.detex over both stations: (histograms, ss_df rows,
    counter deltas, the prepared chunks' threads, the draws' threads,
    the batches' chunk indices, the warnings, torch calls off the
    engine's thread, on it)."""
    stations, X = _inputs()
    prep_s, draw_s = PACES[pace] if pace else (0.0, 0.0)
    engine = threading.get_ident()
    prepared, drawn, batches, warned, off, on = [], [], [], [], [], []
    events = []          # "d" a batch stacked for dispatch, "m" one materialized

    def chunks(sta):
        for b in range(N_CHUNKS):
            drawn.append(threading.get_ident())
            time.sleep(draw_s)
            if (sta, b) == EMPTY:
                yield TStream([]), None, None
                continue
            n = 150 if (sta, b) == SHORT else L
            yield TStream([TTrace(X[sta][b, c::3][:n].copy(), dict(
                network="XX", station=sta[3:], channel="BH" + "ENZ"[c],
                sampling_rate=SR, starttime=STARTS[b]))
                for c in range(3)]), None, None
        drawn.append(threading.get_ident())

    real_prep = tdetect._SSDetex._prepChunk
    real_stack = tdetect._SSDetex._stackBatch
    real_mat = tdetect._SSDetex._materializeOne
    real_prepChunk = tdetect.prepChunk
    real_log = detex_torch.log

    def prep(self, st, sta, *a):
        prepared.append(threading.get_ident())
        time.sleep(prep_s)
        return real_prep(self, st, sta, *a)

    def stack(self, batch, *a):
        batches.append([int(round((c[2] - STARTS[0]) / 400.0))
                        for c in batch])
        events.append("d")
        return real_stack(self, batch, *a)

    def materialize(self):
        events.append("m")
        return real_mat(self)

    def prepChunk(st, *a, **kw):
        if (st[0].stats.station == FAILS[0][3:] and
                st[0].stats.starttime.timestamp == STARTS[FAILS[1]]):
            raise ValueError("a filter that fails")
        return real_prepChunk(st, *a, **kw)

    def log(name, msg, level="info", e=None):
        if level == "warning":
            warned.append((msg, threading.get_ident()))
        return real_log(name, msg, level=level, e=e)

    def guard(name, orig):
        def f(*a, **kw):
            (on if threading.get_ident() == engine else off).append(name)
            return orig(*a, **kw)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdetect._SSDetex, "_prepChunk", prep)
        mp.setattr(tdetect._SSDetex, "_stackBatch", stack)
        mp.setattr(tdetect._SSDetex, "_materializeOne", materialize)
        mp.setattr(tdetect, "prepChunk", prepChunk)
        mp.setattr(detex_torch, "log", log)
        for mod, names in GUARDED.items():
            for name in names:
                mp.setattr(mod, name, guard(name, getattr(mod, name)))
        if inline:
            mp.setattr(tdetect, "_prepWorker", _Inline)
        before = trace.counters()
        hist = tdetect.detex(stations, chunks, str(db), conDatDuration=380.0,
                             conBuff=20.0, filt=[1, 8, 2, True], device="cpu",
                             batchSize=BATCH, devicePrep=devicePrep)
        after = trace.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    return dict(hist=hist, rows=tutil.loadSQLite(str(db), "ss_df"),
                counts=delta, prepared=prepared, drawn=drawn,
                batches=batches, events=events, warned=warned, off=off,
                on=on, engine=engine)


_RUNS = {}


def _cached(tmp_path_factory, devicePrep, pace, inline=False):
    key = (devicePrep, pace, inline)
    if key not in _RUNS:
        wd = tmp_path_factory.mktemp("prep_ahead")
        _RUNS[key] = _run(wd / "ss.db", devicePrep, pace, inline)
    return _RUNS[key]


def _same(got, want):
    assert len(want["rows"]) > 0
    assert repr(got["rows"]) == repr(want["rows"])
    # one bank and one detector that triggers: rows in draw order
    for sta in ("XX.S1", "XX.S2"):
        stmp = [r["STMP"] for r in got["rows"] if r["Sta"] == sta]
        assert stmp and stmp == sorted(stmp), sta
    assert sorted(got["hist"]) == sorted(want["hist"])
    for sta, v in want["hist"].items():
        if sta == "Bins":
            assert np.array_equal(v, got["hist"][sta])
            continue
        for name, counts in v.items():
            assert np.array_equal(counts, got["hist"][sta][name]), (sta, name)


CASES = [(dp, pace) for dp in (False, True) for pace in sorted(PACES)]


@pytest.mark.parametrize("devicePrep,pace", CASES)
def test_rows_and_histograms_same_as_inline(tmp_path_factory, devicePrep,
                                            pace):
    got = _cached(tmp_path_factory, devicePrep, pace)
    want = _cached(tmp_path_factory, devicePrep, None, inline=True)
    _same(got, want)
    # every chunk but the empty one prepared, on the worker; the short
    # and the failed one left out of the batches
    assert len(got["prepared"]) == 2 * N_CHUNKS - 1
    assert got["engine"] not in set(got["prepared"])
    assert set(want["prepared"]) == {want["engine"]}
    assert got["counts"]["chunks"] == 2 * N_CHUNKS - 3
    # the usable chunks in draw order, BATCH at a time: S1 lacks 2 and 4,
    # S2 lacks 1 (one bank, so one stack a batch)
    assert got["batches"] == want["batches"] == [[0, 1, 3], [5, 6],
                                                 [0, 2, 3], [4, 5, 6]]
    assert got["counts"]["batches"] == want["counts"]["batches"] == 4
    for k in ("chunks", "chunks_gated", "rows_written", "prep.fused",
              "prep.fallback"):
        assert got["counts"].get(k, 0) == want["counts"].get(k, 0), k


@pytest.mark.parametrize("devicePrep,pace", CASES)
def test_iterator_drawn_on_the_calling_thread(tmp_path_factory, devicePrep,
                                              pace):
    got = _cached(tmp_path_factory, devicePrep, pace)
    assert len(got["drawn"]) == 2 * (N_CHUNKS + 1)
    assert set(got["drawn"]) == {got["engine"]}


@pytest.mark.parametrize("devicePrep,pace", CASES)
def test_ahead_and_waited_count_every_prepared_chunk(tmp_path_factory,
                                                     devicePrep, pace):
    got = _cached(tmp_path_factory, devicePrep, pace)
    c = got["counts"]
    ahead, waited = c.get("prep.ahead", 0), c.get("prep.waited", 0)
    assert ahead + waited == len(got["prepared"]) == 2 * N_CHUNKS - 1
    # the side that sets the pace decides which of the two counts
    if pace == "slow-prep":
        assert waited >= 1
    else:
        assert ahead >= 1
    want = _cached(tmp_path_factory, devicePrep, None, inline=True)["counts"]
    assert want.get("prep.ahead", 0) == 2 * N_CHUNKS - 1
    assert want.get("prep.waited", 0) == 0


@pytest.mark.parametrize("devicePrep,pace", CASES)
def test_skipped_chunks_warn_once_each(tmp_path_factory, devicePrep, pace):
    got = _cached(tmp_path_factory, devicePrep, pace)
    msgs = [m for m, _ in got["warned"]]
    assert sum(m.startswith("could not get data on XX.S1") for m in msgs) == 1
    assert sum(m == "failed to filter chunk on XX.S2" for m in msgs) == 1
    want = _cached(tmp_path_factory, devicePrep, None, inline=True)
    assert sorted(msgs) == sorted(m for m, _ in want["warned"])


@pytest.mark.parametrize("devicePrep,pace", CASES)
def test_worker_makes_no_torch_call(tmp_path_factory, devicePrep, pace):
    got = _cached(tmp_path_factory, devicePrep, pace)
    assert got["off"] == []
    assert "as_tensor" in got["on"]      # the guards do see the uploads


def _raising(where, db):
    """A run whose iterator, second chunk's prep or second dispatch
    raises; the error's message."""
    stations, X = _inputs()
    real_prep = tdetect._SSDetex._prepChunk
    real_stack = tdetect._SSDetex._stackBatch
    calls = {"prep": 0, "dispatch": 0}

    def chunks(sta):
        for b in range(N_CHUNKS):
            if where == "iterator" and sta == "XX.S2" and b == 4:
                raise RuntimeError("iterator")
            yield TStream([TTrace(X[sta][b, c::3].copy(), dict(
                network="XX", station=sta[3:], channel="BH" + "ENZ"[c],
                sampling_rate=SR, starttime=STARTS[b]))
                for c in range(3)]), None, None

    def prep(self, *a):
        calls["prep"] += 1
        if where == "prep" and calls["prep"] == 2:
            raise RuntimeError("prep")
        return real_prep(self, *a)

    def stack(self, *a):
        calls["dispatch"] += 1
        if where == "dispatch" and calls["dispatch"] == 2:
            raise RuntimeError("dispatch")
        return real_stack(self, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdetect._SSDetex, "_prepChunk", prep)
        mp.setattr(tdetect._SSDetex, "_stackBatch", stack)
        with pytest.raises(RuntimeError) as err:
            tdetect.detex(stations, chunks, str(db), conDatDuration=380.0,
                          conBuff=20.0, filt=[1, 8, 2, True], device="cpu",
                          batchSize=BATCH)
    return str(err.value)


@pytest.mark.parametrize("where", ["iterator", "prep", "dispatch"])
def test_errors_propagate_and_no_thread_outlives_the_call(tmp_path, where):
    before = threading.active_count()
    assert _raising(where, tmp_path / "err.db") == where
    assert threading.active_count() == before
    assert not [t for t in threading.enumerate()
                if t.name.startswith("detex-prep")]


def _early(events):
    """Materializes that left no batch in flight before the last dispatch:
    made while the engine waited for a prep, not after a dispatch."""
    last, n, out = len(events) - 1 - events[::-1].index("d"), 0, 0
    for i, e in enumerate(events):
        n += 1 if e == "d" else -1
        out += e == "m" and n == 0 and i < last
    return out


@pytest.mark.parametrize("devicePrep", [False, True])
def test_batches_in_flight_materialize_while_prep_runs(tmp_path_factory,
                                                       devicePrep):
    """Inline, a batch materializes after the next dispatch; when the
    engine would wait for the worker it materializes the batch in flight
    first, in the same order (the rows are the same, as held above)."""
    want = _cached(tmp_path_factory, devicePrep, None, inline=True)
    got = _cached(tmp_path_factory, devicePrep, "slow-prep")
    assert want["events"].count("m") == want["events"].count("d") == 4
    assert got["events"].count("m") == got["events"].count("d") == 4
    assert _early(want["events"]) == 0
    assert _early(got["events"]) >= 1
