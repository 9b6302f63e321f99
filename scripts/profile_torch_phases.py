"""
Device-time breakdown of detex_torch's chip_smoke phases on one CUDA card,
by torch.profiler:

  phase A  one summary-only scan_chunks launch at the bench subspace shape
           (256 two-hour chunks, one 4-dim subspace of 30 s templates);
  phase C  the dense re-verify part of a phase C batch: one
           ds.run_bank_triggers_batch call on 8 of those chunks, each with
           a planted event, STA/LTA on (its scan part is phase A);
  phase B  one serving.scan_station request (128 detectors, 8 x 3720 s);
  phase D1 one request of 128 detectors of 60 s templates on 32 chunks
           (route "plain", blk 32768);
  phase D2 one request of phase B's shape on 64 chunks (route "plain");
  phase D3 one scan_chunks launch of a 90 s subspace with the block
           pinned at 16384 on 16 two-hour chunks (route "fused-sub");
  phase E1 one serving.scan_station_raw request (128 detectors at 50 Hz,
           raw 8 x 3720 s at 100 Hz, decimate 2, route
           "fused-net+fusedprep+devicePrep");
  phase E2 one scan_chunks launch of a 16 x 4 full-length bank on 8 chunks
           of 3720 s (route "plain", ds_finalize);
  phase E3 one scan_chunks_raw launch of that bank's shape at 50 Hz on 8
           raw chunks (route "raw-demux+devicePrep");
  phase F1 one detect.detex run of phase F1's subspace station (8
           detectors of 30 s, D = 4, 24 chunks of 3720 s, three planted
           events) on chunks made before the profiler starts, then the
           same run's host time by function (cProfile, the 14 largest by
           own time);
  phase G2 (argument ``G`` only) phase G2's SVD stage without FAS and one
           station's FAS of its 20 subspaces, each with its wall time,
           device-busy time and host time by function.

For each it prints the wall time and the device-busy time per repeat (the
union of all device intervals) and the profiler's table of device time by
kernel. Run from the repository root (with the argument ``E``, ``F`` or
``G``, that phase alone):

    python3 scripts/profile_torch_phases.py [E | F | G]
"""
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())
import chip_smoke as cs                                    # noqa: E402
from detex_torch import detect, serving                    # noqa: E402
from detex_torch.ops import ds as tds                      # noqa: E402
from detex_torch.parallel import scan as tscan             # noqa: E402


def prof(name, fn, reps=3, setup=tuple):
    """Profile ``reps`` calls of fn(*setup()) after one warm call; each
    call's arguments are made before the profiler starts."""
    fn(*setup())
    torch.cuda.synchronize()
    args = [setup() for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for a in args:
            fn(*a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in p.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = cs.busy_us(dev_events)
    print("%s: wall %.3f ms/rep, device busy %.3f ms/rep (%.1f%%)"
          % (name, wall * 1e3 / reps, busy / 1e3 / reps,
             100 * busy / 1e6 / wall), flush=True)
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=16),
          flush=True)


def phase_e(dev):
    with tempfile.TemporaryDirectory() as tmp:
        e1 = cs.phase_e1_setup(dev, tmp)
        prof("phase E1 request", lambda: serving.scan_station_raw(
            e1["dep"], cs.SERVE_STA, e1["X"], max_trig=8), reps=2)
    del e1
    torch.cuda.empty_cache()
    e2 = cs.phase_e2_setup(dev)
    prof("phase E2 launch", lambda: tscan.scan_chunks(
        e2["X"], e2["bank"], np.full(16, 0.5, np.float32), cs.NC, 2000,
        max_trig=8), reps=2)
    del e2
    torch.cuda.empty_cache()
    e3 = cs.phase_e3_setup(dev)
    prof("phase E3 launch", lambda: tscan.scan_chunks_raw(
        e3["X"], e3["lens"], e3["H"], e3["bank"],
        np.full(16, 0.5, np.float32), cs.NC, 1000, max_trig=8, dec=cs.DEC),
        reps=2)


def phase_f(dev):
    rng = np.random.default_rng(61)
    L = int(cs.F_SEC * cs.SR)
    n = int(30 * cs.SR * cs.NC)
    dets = cs.f_detectors(rng, "ss", 8, 4, n, True)
    planted = cs.f_plant(dets, [(2, 0, 40000), (9, 3, 3000),
                                (18, 6, 123456)], n)
    stations, chunks = cs.f_station("XX.F1ss", dets, cs.SR, L, 24, 610,
                                    planted)
    with tempfile.TemporaryDirectory() as tmp:
        # the chunks are made before each run, as F1 times them
        def run(made):
            detect.detex(stations, made, os.path.join(tmp, "f.db"),
                         batchSize=8, device=dev)
        prof("phase F1 subspace station (24 chunks)", run, reps=1,
             setup=lambda: (cs.f_made(chunks, "XX.F1ss"),))
        made = cs.f_made(chunks, "XX.F1ss")
        host = cProfile.Profile()
        host.enable()
        run(made)
        torch.cuda.synchronize()
        host.disable()
        pstats.Stats(host).sort_stats("tottime").print_stats(14)


def host_profile(fn, rows=14):
    """Run fn() under cProfile and the device profiler: wall, device busy
    and the host's time by function."""
    host = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        host.enable()
        fn()
        torch.cuda.synchronize()
        host.disable()
        wall = time.perf_counter() - t0
    busy = cs.busy_us([e for e in p.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA])
    print("wall %.3f s, device busy %.3f s (%.1f%%)"
          % (wall, busy / 1e6, 100 * busy / 1e6 / wall), flush=True)
    pstats.Stats(host).sort_stats("tottime").print_stats(rows)


def phase_g(dev):
    """Phase G2's SVD stage without FAS (validateClusters, the SVDs and
    the energy capture of 2 x 20 subspaces: SVD with a fixed threshold)
    and one station's FAS of its 20 subspaces, each under cProfile and
    the device profiler."""
    from detex_torch import construct, fas
    from detex_torch.kernels import build
    build.load_library()                     # not inside a profile
    g = dict(zip(("events", "waves"), cs.g_catalog()))
    g.update(zip(("streams", "templates", "picks"),
                 cs.g_templates(g["events"], g["waves"])))
    cl = construct.createCluster(streams=g["streams"],
                                 templates=g["templates"],
                                 filt=cs.G_FILT, trim=list(cs.G_TRIM),
                                 saveclust=False, device=dev)
    ss = construct.createSubSpace(clust=cl, dtype="single",
                                  conDatDuration=cs.F_SEC - 120.0,
                                  conBuff=120.0)
    ss.attachPickTimes(g["picks"], defaultDuration=30)
    print("phase G2 SVD stage (threshold given, no FAS):", flush=True)
    host_profile(lambda: ss.SVD(threshold=0.05, useSingles=False))
    sta = cs.G_STATIONS[0]
    print("phase G2 FAS of %s's %d subspaces (conDatNum %d):"
          % (sta, len(ss.subspaces[sta]), cs.G_CON_DAT_NUM), flush=True)
    host_profile(lambda: fas._initFAS(
        ss.subspaces[sta], cs.G_CON_DAT_NUM, cl, cs.g_null_chunks(),
        cs.F_SEC, staltalimit=8.0, dtype="single", device=dev))


def main():
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if sys.argv[1:] == ["F"]:
        phase_f(dev)
        return
    if sys.argv[1:] == ["G"]:
        phase_g(dev)
        return
    phase_e(dev)
    if sys.argv[1:] == ["E"]:
        return
    rng = np.random.default_rng(1)
    U = cs.basis(rng, 4, 9000)
    bank = tds.build_bank([U], cs.NC, 2160000, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((256, 2160000), generator=g, device=dev)
    th = np.full(1, 0.5, np.float32)
    prof("phase A scan", lambda: tscan.scan_chunks(
        X, bank, th, cs.NC, 2000, max_trig=16, calc_triggers=False))
    X = X[:8].clone()
    torch.cuda.empty_cache()
    amp = float(np.sqrt(9000 * 0.6 / 0.4))
    for b in range(8):
        off = cs.NC * (50000 + 60000 * b)
        X[b, off:off + 9000] += torch.as_tensor(
            (amp * U[0]).astype(np.float32), device=dev)
    prof("phase C re-verify (8 chunks)", lambda: tds.run_bank_triggers_batch(
        None, bank, cs.NC, [[0]] * 8, [[0.3]] * 8, [cs.SR] * 8, 5.0, 0.0,
        True, max_triggers=4096, x_dev=X, lens_dev=[2160000] * 8))
    del X
    torch.cuda.empty_cache()

    rng = np.random.default_rng(2)
    S = 128
    sta = "XX.S01"
    Us = [cs.basis(rng, 1, 9000) for _ in range(S)]
    meta = {"stations": {sta: {"nc": cs.NC, "sr": cs.SR, "detectors": [
        dict(name="SG%03d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["e"]) for s in range(S)]}},
        "filt": [], "decimate": 1, "version": 1}
    arrays = {"U__%s__SG%03d" % (sta, s): Us[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "detectors.npz")
        np.savez(path, **arrays)
        dep = serving.load_detectors(path, chunk_sec=3600, conBuff=120,
                                     device=dev)
    XB = rng.standard_normal((8, 1116000)).astype(np.float32)
    prof("phase B request", lambda: serving.scan_station(
        dep, sta, XB, max_trig=16), reps=2)
    del dep, XB
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        for tag, secs, B, amp in (("D1", 60.0, 32, 3.0 * np.sqrt(18000)),
                                  ("D2", 30.0, 64, None)):
            su = cs.serving_setup(dev, tmp, tag, 128, B, secs, 8, amp=amp)
            prof("phase %s request" % tag, lambda: serving.scan_station(
                su["dep"], cs.SERVE_STA, su["X"], max_trig=16), reps=2)
            del su
            torch.cuda.empty_cache()
    d3 = cs.phase_d3_setup(dev)
    prof("phase D3 launch", lambda: tscan.scan_chunks(
        d3["X"], d3["bank"], np.full(1, 0.5, np.float32), cs.NC, 2000,
        max_trig=8))


if __name__ == "__main__":
    main()
