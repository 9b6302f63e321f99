"""detex_torch.trace: the engine's spans and counters, on a tiny engine run
on the CPU (one station, five chunks of 400 s, batches of two) through the
host prep, the device prep and the per-chunk path.

Tracing is off by default and then records nothing; on, every span of the
stage table appears, each child inside its parent on its thread, each
batch's dispatch and materialize under one batch id, and self times are
totals less children. The counters agree with what the run handed over
and wrote, and the rows and histograms are the same bit for bit with
tracing on and off. The kernel launches and scan routes are the
registry's counters under their old module names.
"""
import sys
import threading
from collections import Counter

import numpy as np
import pytest

from detex_torch import detect as tdetect
from detex_torch import trace
from detex_torch import util as tutil
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace
from detex_torch.ops import cuda_kernels as tck
from detex_torch.ops import ds as tds
from detex_torch.parallel import scan as tscan

SR = 25.0
L = 10000            # samples a channel: 400 s
N_CHUNKS = 5
BATCH = 2

PATHS = {
    "host-prep": dict(batchSize=BATCH),
    "device-prep": dict(batchSize=BATCH, devicePrep=True),
    "per-chunk": dict(batchSize=1),
    "host-prep-double": dict(batchSize=BATCH, dtype="double"),
}

# the spans each path opens, and the names each may open inside
SPANS = {
    "host-prep": {"banks", "fetch", "prep", "dispatch", "batch", "upload",
                  "scan", "materialize", "wait", "gate", "reverify", "rows",
                  "mags", "sqlite", "hist"},
    "device-prep": {"banks", "fetch", "prep", "dispatch", "batch", "upload",
                    "scan", "materialize", "wait", "gate", "reverify",
                    "reverify.filter", "rows", "mags", "sqlite", "hist"},
    "per-chunk": {"banks", "fetch", "prep", "scan", "upload", "wait", "rows",
                  "mags", "sqlite"},
    # dtype="double" re-verifies on the host in float64, row by row
    "host-prep-double": {"banks", "fetch", "prep", "dispatch", "batch",
                         "upload", "scan", "materialize", "wait", "gate",
                         "reverify", "reverify.host", "rows", "mags",
                         "sqlite", "hist"},
}
PARENTS = {
    "banks": {None}, "fetch": {None}, "prep": {None}, "prep.wait": {None},
    "dispatch": {None},
    "materialize": {None}, "batch": {"dispatch"},
    "scan": {"dispatch", None}, "upload": {"dispatch", "scan", "reverify"},
    "wait": {"materialize", "reverify", "reverify.host", "scan", "rows",
             None},
    "gate": {"materialize"}, "reverify": {"materialize"},
    "reverify.filter": {"reverify"}, "reverify.host": {"rows"},
    "rows": {"materialize", None},
    "mags": {"rows"}, "sqlite": {"rows"}, "hist": {"materialize"},
}


def _inputs(seed=3):
    """One station with two detectors of 600 multiplexed samples (a
    demuxed bank the device prep can filter) and five chunks, an event
    of the first detector in chunks 1 and 3."""
    rng = np.random.default_rng(seed)
    dets = []
    for k in range(2):
        u = rng.standard_normal(600)
        U = (u / np.linalg.norm(u))[None]
        dets.append(dict(name="d%d" % k, U=U, WFs=3.0 * U, mags=[1.0],
                         events=["e%d" % k], offsets=[0.0], threshold=0.3))
    X = rng.standard_normal((N_CHUNKS, 3 * L))
    for b, at in ((1, 2000), (3, 6000)):
        X[b, 3 * at:3 * at + 600] += 150.0 * dets[0]["U"][0]
    stations = {"XX.S1": dict(channels=["BHE", "BHN", "BHZ"], sr=SR,
                              detectors=dets)}

    def chunks(sta):
        for b in range(N_CHUNKS):
            yield TStream([TTrace(X[b, c::3].copy(), dict(
                network="XX", station="S1", channel="BH" + "ENZ"[c],
                sampling_rate=SR, starttime=1e9 + 400.0 * b))
                for c in range(3)]), None, None
    return stations, chunks


def _run(db, path, on):
    stations, chunks = _inputs()
    trace.reset()
    before = trace.counters()
    if on:
        trace.enable()
    try:
        hist = tdetect.detex(stations, chunks, str(db), conDatDuration=380.0,
                             conBuff=20.0, filt=[1, 8, 2, True],
                             device="cpu", **PATHS[path])
    finally:
        trace.disable()
    after = trace.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()}
    return hist, tutil.loadSQLite(str(db), "ss_df"), trace.snapshot(), delta


@pytest.fixture(scope="module", params=sorted(PATHS))
def runs(request, tmp_path_factory):
    wd = tmp_path_factory.mktemp("trace_" + request.param)
    return (request.param, _run(wd / "off.db", request.param, False),
            _run(wd / "on.db", request.param, True))


def test_off_by_default_records_nothing(runs):
    _, (_, rows, snap, _), _ = runs
    assert rows
    assert snap["spans"] == []
    assert trace.span("fetch") is trace.span("prep", batch=3)
    assert trace.span("fetch").__enter__() is None


def test_off_span_is_one_object_and_reads_no_clock(monkeypatch):
    class NoClock(object):
        @staticmethod
        def perf_counter_ns():
            raise AssertionError("a clock read while tracing is off")
    monkeypatch.setattr(trace, "time", NoClock)
    trace.reset()
    handed = []
    for _ in range(1000):
        with trace.span("fetch", batch=1) as s:
            assert s is None
        handed.append(trace.span("prep"))
    assert len({id(h) for h in handed}) == 1
    assert trace.snapshot()["spans"] == []


def test_every_span_nested_on_its_thread(runs):
    path, _, (_, _, snap, c) = runs
    spans = snap["spans"]
    # prep.wait: the engine blocked on a chunk's prep, once each time
    # prep.waited counts; how often is timing (never on the per-chunk path)
    assert {s["name"] for s in spans} - {"prep.wait"} == SPANS[path]
    assert sum(s["name"] == "prep.wait" for s in spans) == \
        c.get("prep.waited", 0)
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        p = by_id.get(s["parent"])
        assert (p and p["name"]) in PARENTS[s["name"]], (s, p)
        if p is not None:
            assert p["thread"] == s["thread"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    disp = [s["batch"] for s in spans if s["name"] == "dispatch"]
    mat = [s["batch"] for s in spans if s["name"] == "materialize"]
    if path == "per-chunk":
        assert disp == mat == []
    else:
        assert len(disp) == -(-N_CHUNKS // BATCH)
        assert sorted(disp) == sorted(mat) == sorted(set(disp))
        assert None not in disp


def test_report_self_is_total_less_children(runs):
    _, _, (_, _, snap, _) = runs
    spans = snap["spans"]
    rep = {r["name"]: r for r in trace.report(spans)}
    assert set(rep) == {s["name"] for s in spans}
    for name, r in rep.items():
        mine = [s for s in spans if s["name"] == name]
        ids = {s["id"] for s in mine}
        total = sum(s["end_ns"] - s["start_ns"] for s in mine)
        kids = sum(s["end_ns"] - s["start_ns"] for s in spans
                   if s["parent"] in ids)
        assert r["calls"] == len(mine)
        assert r["total_s"] == pytest.approx(total / 1e9, abs=1e-9)
        assert r["self_s"] == pytest.approx((total - kids) / 1e9, abs=1e-9)
        assert 0 <= r["self_s"] <= r["total_s"] + 1e-9


@pytest.mark.parametrize("path", sorted(PATHS))
def test_counters_match_the_run(path, tmp_path, monkeypatch):
    handed, depth = [], [0]
    real = {k: getattr(tscan, k) for k in ("scan_chunks", "scan_chunks_raw")}
    real_rv = tds.run_bank_triggers_batch

    def scan(name):
        def f(X, *a, **kw):
            # the batch the engine hands over (scan_chunks_raw calls
            # scan_chunks on the device's own multiplexed batch)
            if not depth[0]:
                handed.append(X.nbytes if isinstance(X, np.ndarray)
                              else X.numel() * X.element_size())
            depth[0] += 1
            try:
                return real[name](X, *a, **kw)
            finally:
                depth[0] -= 1
        return f

    def reverify(x_list, bank, *a, **kw):
        if kw.get("x_dev") is None:
            handed.append(len(x_list) * int(bank["pad_len"]) * 4)
        return real_rv(x_list, bank, *a, **kw)

    for name in real:
        monkeypatch.setattr(tscan, name, scan(name))
    monkeypatch.setattr(tds, "run_bank_triggers_batch", reverify)
    _, rows, _, c = _run(tmp_path / "c.db", path, False)
    assert c["chunks"] == N_CHUNKS
    assert c["rows_written"] == len(rows) > 0
    assert c["d2h_bytes"] > 0
    if path == "per-chunk":
        assert c.get("batches", 0) == c.get("chunks_gated", 0) == 0
        return
    assert c["batches"] == -(-N_CHUNKS // BATCH)
    assert 1 <= c["chunks_gated"] <= N_CHUNKS
    assert 1 <= c["reverify_rows_gated"] <= c["reverify_rows_computed"]
    # the scan's own upload counts what the engine kept on the device once
    assert c["h2d_bytes"] == sum(handed)


def test_rows_and_histograms_same_on_and_off(runs):
    _, (h_off, r_off, _, c_off), (h_on, r_on, snap, c_on) = runs
    assert snap["spans"]
    assert repr(r_on) == repr(r_off)
    assert sorted(h_on) == sorted(h_off)
    for sta, v in h_off.items():
        if sta == "Bins":
            assert np.array_equal(v, h_on[sta])
            continue
        for name, counts in v.items():
            assert np.array_equal(counts, h_on[sta][name]), (sta, name)
    # whether a chunk's prep had ended when the engine took it is timing:
    # only the sum of prep.ahead and prep.waited is the run's own
    timing = ("prep.ahead", "prep.waited")
    assert {k: v for k, v in c_on.items() if k not in timing} == \
        {k: v for k, v in c_off.items() if k not in timing}
    assert sum(c_on.get(k, 0) for k in timing) == \
        sum(c_off.get(k, 0) for k in timing)


def test_launches_and_routes_are_the_registrys(tmp_path):
    assert isinstance(tck.LAUNCHES, dict)
    saved = dict(tck.LAUNCHES)
    try:
        tck.reset_launches()
        assert not any(tck.LAUNCHES.values())
        tck._count("spec_ds_fold")
        got = trace.counters()
        assert got["launches.spec_ds_fold"] == 1
        assert {k for k in got if k.startswith("launches.")} == \
            {"launches." + k for k in tck.LAUNCHES}
    finally:
        tck.LAUNCHES.update(saved)
    tscan.ROUTE_COUNTS.clear()
    _run(tmp_path / "r.db", "host-prep", False)
    routes = {k[len("routes."):]: v for k, v in trace.counters().items()
              if k.startswith("routes.")}
    assert routes == dict(tscan.ROUTE_COUNTS)
    assert tscan.ROUTE_COUNTS["dense-reverify-device"] >= 1
    assert sum(v for k, v in tscan.ROUTE_COUNTS.items()
               if k.startswith("fused")) == -(-N_CHUNKS // BATCH)


def test_counts_from_many_threads_are_not_lost():
    """Sharded scans count from a host thread a card: no lost update."""
    n_threads, n_each = 16, 2000
    counts = Counter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count("stress", counts=counts) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["stress"] == n_threads * n_each


@pytest.mark.parametrize("path", ["host-prep", "device-prep"])
def test_mesh_scan_is_spanned_once_a_bank(path, tmp_path, monkeypatch):
    """On a mesh the shards open "scan" and the engine does not: as many
    scans as without a mesh, each inside its batch's dispatch, and the
    same rows."""
    from detex_torch.parallel import mesh as tmesh
    _, rows, snap, _ = _run(tmp_path / "one.db", path, True)
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    monkeypatch.setattr(tscan, "engine_mesh", lambda device=None: mesh)
    _, rows_m, snap_m, _ = _run(tmp_path / "mesh.db", path, True)
    assert repr(rows_m) == repr(rows)
    scans = [s for s in snap["spans"] if s["name"] == "scan"]
    scans_m = [s for s in snap_m["spans"] if s["name"] == "scan"]
    by_id = {s["id"]: s for s in snap_m["spans"]}
    assert len(scans_m) == len(scans) > 0
    assert {by_id[s["parent"]]["name"] for s in scans_m} == {"dispatch"}
