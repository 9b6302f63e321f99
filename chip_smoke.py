#!/usr/bin/env python3
"""
Smoke run of detex_torch on one NVIDIA GPU of compute capability 9.0 (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch twin on the card (at the small test
geometry, at blk 32768, at phase A's geometry cut to 16 chunks, at phase
B's shape, and after the main-path run at phase A's full shape), then
drives the port's main path through the entry points a user calls:

  phase A  the engine's summary-only scan (parallel/scan.scan_chunks with
           calc_triggers=False) of 256 two-hour three-component chunks at
           100 Hz against one 4-dim subspace of 30 s templates, with events
           planted in three chunks and checked against the float64 oracle;
  phase B  serving: a 128-detector artifact written in detex_tpu's
           export_detectors schema, loaded with serving.load_detectors and
           scanned with serving.scan_station (triggers on), planted events
           found at the oracle's argmax index.

Data and weights are random from fixed seeds. Every phase's failure raises;
the run exits 0 only when all pass. The last lines are the kernels' JSON
record, the card's name and power limit from nvidia-smi, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

import detex_torch
from detex_torch.kernels import build
from detex_torch.ops import cuda_kernels as ck
from detex_torch.ops import dft
from detex_torch.ops import ds as tds
from detex_torch.ops import reference as ref
from detex_torch.parallel import scan as tscan
from detex_torch import serving

NC = 3
SR = 100.0
NBIN = 400
KERNEL_INFO = {
    "fwd_prep_fold": ("detex_torch/kernels/fwd_prep_fold.cu",
                      "detex_tpu/ops/pallas_kernels.py:1437"),
    "spec_ds_fold": ("detex_torch/kernels/spec_ds_fold.cu",
                     "detex_tpu/ops/pallas_kernels.py:1038"),
}


def say(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sm_clock():
    """Current and maximum SM clock as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3, warm_s=0.3):
    """Mean milliseconds of fn() on the card over ``reps`` runs, by CUDA
    events, after repeating it for ``warm_s`` seconds: a short burst after
    host-side work would otherwise be timed before the SM clock ramps."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= warm_s:
            break
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def basis(rng, D, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, D)))
    return np.ascontiguousarray(q[:, :D].T)


class Failure(AssertionError):
    pass


def need(cond, msg):
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its twin on the same inputs
# ---------------------------------------------------------------------------

def compare_prep(xq, n_c, blk, out_len, timing=False):
    k = ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)
    r = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    torch.cuda.synchronize()
    Rp = dft.half_rp(blk)
    R = blk // 2 + 1
    m = k[0].shape[1] // Rp
    err = 0.0
    for a, b in zip(k[:2], r[:2]):
        a = a.reshape(-1, m, Rp)
        b = b.reshape(-1, m, Rp)
        err = max(err, (a[..., :R] - b[..., :R]).abs().max().item())
        need(bool((a[..., R:] == 0).all()), "spectra past blk/2 not zero")
    need(err <= 2e-3, "fwd_prep_fold spectra err %g > 2e-3" % err)
    a_err = (k[2][:, :out_len] - r[2][:, :out_len]).abs().max().item()
    need(a_err <= 1e-4, "fwd_prep_fold a err %g > 1e-4" % a_err)
    need(torch.allclose(k[3][:, :out_len], r[3][:, :out_len], rtol=1e-4,
                        atol=1e-3), "fwd_prep_fold power off tolerance")
    need(bool((k[2][:, out_len:] == 0).all())
         and bool((k[3][:, out_len:] == 1).all()),
         "fwd_prep_fold pad values not exact")
    out = dict(err=err, a_err=a_err, prep=r)
    if timing:
        out["ms"] = cuda_ms(lambda: ck.fwd_prep_fold(xq, NC, n_c, blk,
                                                     out_len))
        out["plain_ms"] = cuda_ms(lambda: ref.fwd_prep_fold_ref(
            xq, NC, n_c, blk, out_len))
    return out


def compare_spec(args, emit_ds, timing=False):
    dk, pk, hk = ck.spec_ds_fold(*args, nbin=NBIN, emit_ds=emit_ds)
    dr, pr, hr = ref.spec_ds_fold_ref(*args, nbin=NBIN, emit_ds=emit_ds)
    torch.cuda.synchronize()
    need(torch.equal(torch.isfinite(pk), torch.isfinite(pr)),
         "spec_ds_fold pyr -inf positions differ")
    fin = torch.isfinite(pr)
    err = (pk[fin] - pr[fin]).abs().max().item() if fin.any() else 0.0
    if emit_ds:
        need(torch.equal(torch.isfinite(dk), torch.isfinite(dr)),
             "spec_ds_fold ds -inf positions differ")
        fin = torch.isfinite(dr)
        err = max(err, (dk[fin] - dr[fin]).abs().max().item())
    else:
        need(dk is None, "summary-only run returned a DS array")
    need(err <= 2e-5, "spec_ds_fold ds/pyr err %g > 2e-5" % err)
    need(torch.equal(hk.sum(1), hr.sum(1)), "histogram row totals differ")
    moves = int((hk - hr).abs().sum().item())
    allowed = int(hr.sum().item()) // 200000
    need(moves <= allowed, "histogram moves %d > %d" % (moves, allowed))
    out = dict(err=err, moves=moves, allowed=allowed)
    if timing:
        out["ms"] = cuda_ms(lambda: ck.spec_ds_fold(
            *args, nbin=NBIN, emit_ds=emit_ds))
        out["plain_ms"] = cuda_ms(lambda: ref.spec_ds_fold_ref(
            *args, nbin=NBIN, emit_ds=emit_ds))
    return out


def kernel_vs_twin(dev, B, Lc, n, S, D, mode, seed, timing=False,
                   block_fft=None, timed_emit_ds=False):
    """Both kernels on one geometry: prep compared on a demuxed chunk
    batch with one empty and one ragged chunk, then spec_ds_fold (emit_ds
    both ways) on the twin's prep output. With ``timing``, spec_ds_fold is
    timed with emit_ds = ``timed_emit_ds``."""
    rng = np.random.default_rng(seed)
    n_c = n // NC
    bank = tds.build_bank([basis(rng, D, n) for _ in range(S)], NC, Lc, dev,
                          block_fft=block_fft)
    blk = bank["blk_fft"]
    L_c = Lc // NC
    out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    g = torch.Generator(device=dev).manual_seed(seed)
    xq = torch.zeros((B, NC, m * W + D0), dtype=torch.float32, device=dev)
    xq[:, :, pad0:pad0 + L_c] = torch.randn((B, NC, L_c), generator=g,
                                            device=dev)
    xq[1] = 0.0                                  # empty padded chunk
    xq[2, :, pad0 + L_c // 2:] = 0.0             # ragged chunk
    p = compare_prep(xq, n_c, blk, out_len, timing)
    Fr, Fi, a, power = p["prep"]
    nv = torch.full((B,), out_len, dtype=torch.int32, device=dev)
    nv[1] = -n_c
    nv[2] = L_c // 2 - n_c + 1
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    args = (ur, ui, Fr, Fi, a, power, su, nv, mode, NC, W, D0, blk)
    res = {"fwd_prep_fold": p}
    for emit_ds in (True, False):
        s = compare_spec(args, emit_ds, timing and emit_ds == timed_emit_ds)
        say("  spec_ds_fold %s blk %d emit_ds=%s: max_abs_err %.3g, hist "
            "moves %d (allowed %d)" % (mode, blk, emit_ds, s["err"],
                                       s["moves"], s["allowed"]))
        agg = res.setdefault("spec_ds_fold", dict(err=0.0))
        agg["err"] = max(agg["err"], s["err"])
        if "ms" in s:
            agg.update(ms=s["ms"], plain_ms=s["plain_ms"])
    say("  fwd_prep_fold blk %d: spectra max_abs_err %.3g, a err %.3g"
        % (blk, p["err"], p["a_err"]))
    return res


# ---------------------------------------------------------------------------
# phase A: engine / bench subspace geometry, summary-only
# ---------------------------------------------------------------------------

def phase_a(dev, B=256, hours=2.0, seed=1):
    rng = np.random.default_rng(seed)
    n = int(30 * SR * NC)                            # 30 s templates
    Lc = int(hours * 3600 * SR * NC)
    U = basis(rng, 4, n)
    bank = tds.build_bank([U], NC, Lc, dev)
    L_c = Lc // NC
    out_len, _, _, W, m = tds._os_geometry(L_c, n // NC, bank["blk_fft"])
    say("phase A: B=%d chunks x %d samples, blk %d W %d m %d"
        % (B, Lc, bank["blk_fft"], W, m))
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, Lc), generator=g, device=dev)
    Ut = torch.as_tensor(U.astype(np.float32), device=dev)
    # (chunk, channel-aligned offset, basis dim)
    planted = [(5, Lc // 30 * 3, 0), (B // 2, Lc // 6 * 3, 1),
               (B - 7, Lc * 3 // 10 * 3, 2)]
    for b, off, d in planted:
        X[b, off:off + n] += 150.0 * Ut[d]
    th = np.full(1, 0.5, np.float32)
    buff = int(20 * SR)

    def step():
        out = tscan.scan_chunks(X, bank, th, NC, buff, max_trig=16,
                                calc_hist=True, calc_triggers=False)
        torch.cuda.synchronize()
        return out

    times = []
    for _ in range(4):                              # first run warms up
        t0 = time.perf_counter()
        out = step()
        times.append(time.perf_counter() - t0)
    hist, maxds = out[0].cpu().numpy(), out[1].cpu().numpy()
    need(maxds.shape == (B, 1) and np.isfinite(maxds).all(),
         "phase A maxds not finite [B, 1]")
    need(int(hist.sum()) == B * out_len,
         "phase A histogram total %d != %d" % (hist.sum(), B * out_len))
    need(out[2].shape[-1] == 0, "summary-only scan returned triggers")
    errs = []
    for b, off, d in planted:
        ds64 = tds.ds_numpy(X[b].double().cpu().numpy(), U, NC)
        err = abs(float(np.nanmax(ds64)) - float(maxds[b, 0]))
        errs.append(err)
        need(err <= 2e-5, "phase A planted chunk %d maxds err %g" % (b, err))
        need(maxds[b, 0] > 0.5, "phase A planted event not seen")
    quiet = np.delete(maxds[:, 0], [b for b, _, _ in planted])
    need(quiet.max() < 0.1, "phase A quiet chunk maxds %g" % quiet.max())
    best = min(times[1:])
    st_days = B * hours / 24.0
    say("phase A: s/launch %s (best %.6f), station-days/s %.3f, planted "
        "maxds err vs float64 oracle %s"
        % ([round(t, 6) for t in times[1:]], best, st_days / best,
           ["%.2e" % e for e in errs]))
    return dict(X=X, bank=bank, s_per_launch=best,
                station_days_per_s=st_days / best, oracle_err=max(errs))


# ---------------------------------------------------------------------------
# phase B: serving
# ---------------------------------------------------------------------------

def phase_b(dev, tmpdir, S=128, B=8, seed=2):
    rng = np.random.default_rng(seed)
    n = int(30 * SR * NC)
    sta = "XX.S01"
    Us = [basis(rng, 1, n) for _ in range(S)]
    meta = {"stations": {sta: {"nc": NC, "sr": SR, "detectors": [
        dict(name="SG%03d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%03d" % s]) for s in range(S)]}},
        "filt": [1.0, 10.0, 2, True], "decimate": 1, "version": 1}
    arrays = {"U__%s__SG%03d" % (sta, s): Us[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = os.path.join(tmpdir, "detectors.npz")
    np.savez(path, **arrays)
    dep = serving.load_detectors(path, chunk_sec=3600, conBuff=120,
                                 device=dev)
    Lc = int(3720 * SR * NC)
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    # (chunk, detector, channel-aligned offset)
    planted = [(0, 3 % S, Lc // 24 * 3), (2 % B, 77 % S, Lc // 6 * 3),
               (5 % B, 127 % S, Lc * 3 // 10 * 3), (B - 1, 40 % S, 33)]
    for b, s, off in planted:
        X[b, off:off + n] += 150.0 * Us[s][0].astype(np.float32)
    say("phase B: %d detectors, B=%d chunks x %d samples, blk %d"
        % (S, B, Lc, dep[sta]["banks"][0]["blk_fft"]))
    times = []
    for _ in range(3):                              # first run warms up
        t0 = time.perf_counter()
        res = serving.scan_station(dep, sta, X, max_trig=16)
        times.append(time.perf_counter() - t0)
    r = res[0]
    need(r["maxds"].shape == (B, S) and np.isfinite(r["maxds"]).all(),
         "phase B maxds not finite [B, S]")
    nv = (Lc - n) // NC + 1
    need(np.array_equal(r["hist"].sum(axis=1), np.full(S, B * nv)),
         "phase B histogram totals off")
    errs = []
    for b, s, off in planted:
        ds64 = tds.ds_numpy(X[b].astype(np.float64), Us[s], NC)
        i64 = int(np.nanargmax(ds64))
        need(r["trig_count"][b, s] >= 1, "phase B event (%d, %d) missed"
             % (b, s))
        need(int(r["trig_idx"][b, s, 0]) == i64,
             "phase B event (%d, %d) at %d, oracle argmax %d"
             % (b, s, r["trig_idx"][b, s, 0], i64))
        err = abs(float(r["trig_val"][b, s, 0]) - float(ds64[i64]))
        errs.append(err)
        need(err <= 2e-5, "phase B event DS err %g" % err)
    hits = {(b, s) for b, s, _ in planted}
    extra = [(b, s) for b in range(B) for s in range(S)
             if r["trig_count"][b, s] and (b, s) not in hits]
    need(not extra, "phase B rows without a planted event triggered: %s"
         % extra[:8])
    best = min(times[1:])
    say("phase B: s/request %s (best %.6f), planted DS err vs float64 "
        "oracle %s, other triggered rows %d"
        % ([round(t, 6) for t in times[1:]], best,
           ["%.2e" % e for e in errs], len(extra)))
    return dict(s_per_request=best, oracle_err=max(errs))


def anatomy(dev, pa):
    """Phase A's launch split into its parts at the full shape (B=256), by
    CUDA events, outside the counted main-path run: the torch glue
    (standardize + demux + pad), and each kernel held against its twin on
    the same inputs (phase-2 tolerances) and timed beside it."""
    X, bank = pa.pop("X"), pa["bank"]
    n_c, blk = bank["n_c"], bank["blk_fft"]
    L_c = X.shape[1] // NC
    _, _, D0, W, _ = tds._os_geometry(L_c, n_c, blk)
    out = dict(glue_ms=cuda_ms(lambda: tds.standardize_demux(X, n_c, NC,
                                                             blk)))
    xq, out_len = tds.standardize_demux(X, n_c, NC, blk)
    del X
    out["fwd_prep_fold"] = compare_prep(xq, n_c, blk, out_len, timing=True)
    Fr, Fi, a, power = out["fwd_prep_fold"].pop("prep")
    del xq
    torch.cuda.empty_cache()
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.full((Fr.shape[0] // NC,), out_len, dtype=torch.int32,
                    device=dev)
    args = (ur, ui, Fr, Fi, a, power, su, nv, "sub", NC, W, D0, blk)
    out["spec_ds_fold"] = compare_spec(args, False, timing=True)
    s = out["spec_ds_fold"]
    say("phase A anatomy (B=%d): glue %.3f ms; fwd_prep_fold kernel %.3f "
        "ms, twin %.3f ms, spectra max_abs_err %.3g; spec_ds_fold "
        "summary-only kernel %.3f ms, twin %.3f ms, pyr max_abs_err %.3g, "
        "hist moves %d (allowed %d) (SM clock %s)"
        % (nv.shape[0], out["glue_ms"], out["fwd_prep_fold"]["ms"],
           out["fwd_prep_fold"]["plain_ms"], out["fwd_prep_fold"]["err"],
           s["ms"], s["plain_ms"], s["err"], s["moves"], s["allowed"],
           sm_clock()))
    return out


def main():
    name = detex_torch.require_cuda()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("card:", card_line())
    say("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda, name))
    t0 = time.perf_counter()
    lib = build.load_library()
    say("kernel build: %.1f s (%s)" % (time.perf_counter() - t0, lib._name))
    with open(os.path.splitext(lib._name)[0] + ".log") as f:
        report = f.read().splitlines()
    for line in report:
        if "registers" in line or "spill" in line:
            say("  ptxas:", line.strip())

    n30 = int(30 * SR * NC)                          # 30 s templates
    say("phase 2: kernels vs twins, small test geometry")
    checks = [kernel_vs_twin(dev, 8, 3 * 35000, 1680, 3, 3, "sub", 11),
              kernel_vs_twin(dev, 4, 3 * 35000, 1680, 8, 3, "net", 12)]
    say("phase 2: kernels vs twins, blk 32768 (n_c 16300, the widest "
        "template the fused route takes there)")
    checks += [kernel_vs_twin(dev, 8, 3 * 200000, 3 * 16300, 1, 2, "sub", 17,
                              block_fft=32768),
               kernel_vs_twin(dev, 4, 3 * 200000, 3 * 16300, 8, 1, "net", 18,
                              block_fft=32768)]
    say("phase 2: kernels vs twins, phase-A geometry cut to B=16")
    timed = kernel_vs_twin(dev, 16, int(7200 * SR * NC), n30, 1, 4, "sub",
                           13, timing=True)
    checks += [timed, kernel_vs_twin(dev, 16, int(7200 * SR * NC), n30, 8, 4,
                                     "net", 14)]
    for k in ("fwd_prep_fold", "spec_ds_fold"):
        say("  %s at B=16: kernel %.3f ms, twin %.3f ms (SM clock %s)"
            % (k, timed[k]["ms"], timed[k]["plain_ms"], sm_clock()))
    say("phase 2: kernels vs twins, phase-B geometry (B=8 x 3720 s, 128 "
        "detectors)")
    timed = kernel_vs_twin(dev, 8, int(3720 * SR * NC), n30, 128, 1, "net",
                           15, timing=True, timed_emit_ds=True)
    checks.append(timed)
    for k in ("fwd_prep_fold", "spec_ds_fold"):
        say("  %s at phase-B shape%s: kernel %.3f ms, twin %.3f ms (SM "
            "clock %s)" % (k, " (emit_ds)" if k == "spec_ds_fold" else "",
                           timed[k]["ms"], timed[k]["plain_ms"], sm_clock()))
    torch.cuda.empty_cache()

    ck.reset_launches()
    tscan.ROUTE_COUNTS.clear()
    pa = phase_a(dev)
    launches_a = dict(ck.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        phase_b(dev, tmp)
    launches = dict(ck.LAUNCHES)
    routes = dict(tscan.ROUTE_COUNTS)
    say("main-path launches: phase A %s, A+B %s; routes %s"
        % (launches_a, launches, routes))
    for k in launches:
        need(launches_a[k] > 0 and launches[k] > launches_a[k],
             "kernel %s did not run on both phases" % k)
    need(routes.get("fused-sub+fusedprep", 0) > 0
         and routes.get("fused-net+fusedprep", 0) > 0,
         "main path did not take the fused routes: %s" % routes)
    times = anatomy(dev, pa)

    # ms / plain_ms: kernel and twin at the main path's full phase-A shape
    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=launches[k],
            max_abs_err=max(r[k]["err"] for r in checks + [times]),
            ms=times[k]["ms"], plain_ms=times[k]["plain_ms"]))
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
