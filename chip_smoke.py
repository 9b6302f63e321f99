#!/usr/bin/env python3
"""
Smoke run of detex_torch on one NVIDIA GPU of compute capability 9.0 (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch twin on the card (the scan kernels at the
small test geometry, at blk 32768, at phase A's geometry cut to 16 chunks,
at phase B's shape and, after the main-path run, at phase A's full shape;
the dense re-verify kernels at the small geometry, at blk 32768 and, after
the main-path run, at phase C's re-verify shape), then drives the port's
main paths through the entry points a user calls:

  phase A  the engine's summary-only scan (parallel/scan.scan_chunks with
           calc_triggers=False) of 256 two-hour three-component chunks at
           100 Hz against one 4-dim subspace of 30 s templates, with events
           planted in three chunks and checked against the float64 oracle;
  phase B  serving: a 128-detector artifact written in detex_tpu's
           export_detectors schema, loaded with serving.load_detectors and
           scanned with serving.scan_station (triggers on), planted events
           found at the oracle's argmax index;
  phase C  the dense re-verify at the bench.py dense geometry: phase A's
           scan of 256 two-hour chunks, 8 of them (3%) with an event
           planted at DS ~ 0.6, threshold 0.3; the chunks whose maximum
           passes the threshold go, as the engine sends them, through
           ops/ds.run_bank_triggers_batch (STA/LTA on, 4096 triggers per
           row), and every planted event must trigger at the float64
           oracle's argmax with its DS within 2e-5.

Each phase runs with the kernels' launch counts set to 0 just before it
and read just after. Data and weights are random from fixed seeds. Every
phase's failure raises; the run exits 0 only when all pass. The last lines
are the kernels' JSON record, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": {...}}.
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
    "ds_finalize_os_fold": ("detex_torch/kernels/ds_finalize_os_fold.cu",
                            "detex_tpu/ops/pallas_kernels.py:575"),
    "rfft_ct_fused": ("detex_torch/kernels/rfft_ct.cu",
                      "detex_tpu/ops/pallas_kernels.py:336"),
    "irfft_ct_fused": ("detex_torch/kernels/irfft_ct.cu",
                       "detex_tpu/ops/pallas_kernels.py:270"),
}
# H100 SXM peaks (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores, the rate every kernel here computes at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``nbytes`` through device memory and do ``flops`` float32 operations,
    the larger of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def rfft_flops(n):
    """Operations of one real FFT of n points (2.5 n log2 n)."""
    return 2.5 * n * np.log2(n)


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


def dense_inputs(X, bank, lens):
    """The dense re-verify kernels' inputs for chunk batch X [B, Lc] with
    valid lengths ``lens``, each stage's input made by the twin of the
    stage before: (frames [B*nc*m, blk], spec [B*S*D*m, R] complex64,
    finalize arguments, twin F) exactly as ops/ds.os_prep_batch and
    os_block_scan_batch build them."""
    n_c, blk, Dmax = bank["n_c"], bank["blk_fft"], int(bank["Dmax"])
    B, S = X.shape[0], int(bank["sum_u"].shape[0])
    L_c = X.shape[1] // NC
    out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    xq, _ = tds.standardize_demux(X, n_c, NC, blk)
    frames = xq.unfold(2, blk, W).reshape(-1, blk)
    a, power = tds.window_stats_rows(xq[:, :, pad0:pad0 + L_c], n_c,
                                     n_c * NC)
    F = ref.rfft_ct_fused_ref(frames, blk).reshape(B, NC, m, -1)
    spec = sum(bank["Ufd2"][None, :, :, c, None, :] * F[:, None, None, c]
               for c in range(NC)).reshape(-1, blk // 2 + 1)
    cb = ref.irfft_ct_fused_ref(spec, blk)
    su = torch.where(bank["d_mask"], bank["sum_u"],
                     torch.zeros_like(bank["sum_u"]))
    nv = torch.tensor([max((L - bank["n"]) // NC + 1, 0) for L in lens],
                      dtype=torch.int32, device=X.device)
    fin = (cb.reshape(B * S * Dmax, m, blk),
           torch.nn.functional.pad(a, (0, m * W - out_len)),
           torch.nn.functional.pad(power, (0, m * W - out_len), value=1.0),
           su[None].expand(B, S, Dmax).reshape(-1).contiguous(), nv, D0,
           Dmax, W, S)
    return frames, spec, fin


def compare_rfft(frames, blk, timing=False):
    k = ck.rfft_ct_fused(frames, blk)
    r = ref.rfft_ct_fused_ref(frames, blk)
    torch.cuda.synchronize()
    err = (k - r).abs().max().item()
    need(err <= 2e-3, "rfft_ct_fused spectra err %g > 2e-3" % err)
    out = dict(err=err)
    if timing:
        out["ms"] = cuda_ms(lambda: ck.rfft_ct_fused(frames, blk))
        out["plain_ms"] = cuda_ms(lambda: ref.rfft_ct_fused_ref(frames, blk))
        out["library_ms"] = cuda_ms(lambda: torch.fft.rfft(frames, n=blk))
        N = frames.shape[0]
        out["bound"] = bound(N * blk * 4 + N * (blk // 2 + 1) * 8,
                             N * rfft_flops(blk))
    return out


def compare_irfft(spec, blk, timing=False):
    k = ck.irfft_ct_fused(spec, blk)
    r = ref.irfft_ct_fused_ref(spec, blk)
    torch.cuda.synchronize()
    diff = (k - r).abs()
    # all-zero rows (an empty chunk's blocks) come out exactly 0
    scale = r.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    rel = (diff / scale).max().item()
    need(rel <= 2e-5, "irfft_ct_fused err %g of the row max > 2e-5" % rel)
    out = dict(err=diff.max().item(), rel=rel)
    if timing:
        out["ms"] = cuda_ms(lambda: ck.irfft_ct_fused(spec, blk))
        out["plain_ms"] = cuda_ms(lambda: ref.irfft_ct_fused_ref(spec, blk))
        out["library_ms"] = cuda_ms(lambda: torch.fft.irfft(spec, n=blk))
        N = spec.shape[0]
        out["bound"] = bound(N * (blk // 2 + 1) * 8 + N * blk * 4,
                             N * rfft_flops(blk))
    return out


def compare_finalize(fin, nbin, timing=False):
    dk, pk, hk = ck.ds_finalize_os_fold(*fin, nbin=nbin)
    dr, pr, hr = ref.ds_finalize_os_fold_ref(*fin, nbin=nbin)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in (("ds", dk, dr), ("pyr", pk, pr)):
        need(torch.equal(torch.isfinite(a), torch.isfinite(b)),
             "ds_finalize_os_fold %s -inf positions differ" % name)
        f = torch.isfinite(b)
        if f.any():
            err = max(err, (a[f] - b[f]).abs().max().item())
    need(err <= 2e-5, "ds_finalize_os_fold ds/pyr err %g > 2e-5" % err)
    moves = allowed = 0
    if nbin:
        need(torch.equal(hk.sum(1), hr.sum(1)), "histogram row totals differ")
        moves = int((hk - hr).abs().sum().item())
        allowed = int(hr.sum().item()) // 200000
        need(moves <= allowed, "histogram moves %d > %d" % (moves, allowed))
    out = dict(err=err, moves=moves, allowed=allowed)
    if timing:
        out["ms"] = cuda_ms(lambda: ck.ds_finalize_os_fold(*fin, nbin=nbin))
        out["plain_ms"] = cuda_ms(lambda: ref.ds_finalize_os_fold_ref(
            *fin, nbin=nbin))
        cb, a, _, _, _, _, D, W, _ = fin
        BS, m = cb.shape[0] // D, cb.shape[1]
        samples = BS * m * W
        out["bound"] = bound(
            samples * D * 4 + 2 * a.numel() * 4 + cb.shape[0] * 4
            + samples * 4 + samples // 128 * 4 + BS * nbin * 4,
            samples * (3 * D + 1))
    return out


def dense_case(dev, B, Lc, n, S, D, seed, block_fft=None):
    """(X, bank, lens): B random chunks, one empty and one ragged, against
    S random D-dim bases of length n."""
    rng = np.random.default_rng(seed)
    bank = tds.build_bank([basis(rng, D, n) for _ in range(S)], NC, Lc, dev,
                          block_fft=block_fft)
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, Lc), generator=g, device=dev)
    X[1] = 0.0                                       # empty chunk
    X[2, Lc // 2:] = 0.0                             # ragged chunk
    return X, bank, [Lc, 0, Lc // 2] + [Lc] * (B - 3)


def dense_vs_twin(X, bank, lens, timing=False):
    """The three dense re-verify kernels on chunk batch X, each on the
    inputs the path gives it, ds_finalize_os_fold with nbin 0 and NBIN."""
    blk = bank["blk_fft"]
    frames, spec, fin = dense_inputs(X, bank, lens)
    res = {"rfft_ct_fused": compare_rfft(frames, blk, timing),
           "irfft_ct_fused": compare_irfft(spec, blk, timing)}
    for nbin in (NBIN, 0):
        f = compare_finalize(fin, nbin, timing and nbin == 0)
        agg = res.setdefault("ds_finalize_os_fold", dict(err=0.0))
        agg.update(f, err=max(agg["err"], f["err"]))
        say("  ds_finalize_os_fold blk %d nbin %d: max_abs_err %.3g, hist "
            "moves %d (allowed %d)" % (blk, nbin, f["err"], f["moves"],
                                       f["allowed"]))
    say("  rfft_ct_fused blk %d (%d rows): spectra max_abs_err %.3g; "
        "irfft_ct_fused (%d rows): max_abs_err %.3g, %.3g of the row max"
        % (blk, frames.shape[0], res["rfft_ct_fused"]["err"], spec.shape[0],
           res["irfft_ct_fused"]["err"], res["irfft_ct_fused"]["rel"]))
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


# ---------------------------------------------------------------------------
# phase C: dense re-verify at the bench.py dense geometry
# ---------------------------------------------------------------------------

def phase_c(dev, rate_a, B=256, hours=2.0, seed=3, trigger_rate=0.03,
            thr=0.3):
    """bench.py dense (bench.py:273-399) on the port: the summary-only scan
    of B chunks, then the dense re-verify of the chunks whose maximum
    passes ``thr`` - 2e-5 (the engine's gate, detect.py:577-582), fed from
    the scan's device-resident batch as the engine does."""
    rng = np.random.default_rng(seed)
    n = int(30 * SR * NC)
    Lc = int(hours * 3600 * SR * NC)
    U = basis(rng, 4, n)
    bank = tds.build_bank([U], NC, Lc, dev)
    amp = float(np.sqrt(n * 0.6 / 0.4))              # DS ~ 0.6 at the plant
    k = max(1, int(round(trigger_rate * B)))
    planted = sorted(int(b) for b in rng.choice(B, size=k, replace=False))
    offs = [int(rng.integers(1, Lc // NC - n // NC - 1)) * NC
            for _ in planted]
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, Lc), generator=g, device=dev)
    Ut = torch.as_tensor(U[0].astype(np.float32), device=dev)
    for b, off in zip(planted, offs):
        X[b, off:off + n] += amp * Ut
    th = np.full(1, thr, np.float32)
    say("phase C: B=%d chunks x %d samples, %d planted (DS ~ 0.6), "
        "threshold %g, blk %d" % (B, Lc, k, thr, bank["blk_fft"]))

    def step():
        out = tscan.scan_chunks(X, bank, th, NC, int(20 * SR), max_trig=1,
                                calc_triggers=False)
        maxds = out[1][:, 0].cpu().numpy()
        trig_b = [b for b in range(B) if maxds[b] > thr - 2e-5]
        sel = X[torch.as_tensor(trig_b, device=dev)]
        res = tds.run_bank_triggers_batch(
            None, bank, NC, [[0]] * len(trig_b), [[thr]] * len(trig_b),
            [SR] * len(trig_b), 5.0, 0.0, True, max_triggers=4096,
            x_dev=sel, lens_dev=[Lc] * len(trig_b))
        torch.cuda.synchronize()
        return trig_b, res

    times = []
    for _ in range(4):                              # first run warms up
        t0 = time.perf_counter()
        trig_b, res = step()
        times.append(time.perf_counter() - t0)
    need(trig_b == planted, "phase C re-verified chunks %s, planted %s"
         % (trig_b, planted))
    errs = []
    for b, off, r in zip(planted, offs, res):
        idx, ds_at, sl_at = r[0]
        ds64 = tds.ds_numpy(X[b].double().cpu().numpy(), U, NC)
        i64 = int(np.nanargmax(ds64))
        need(len(idx) == 1, "phase C chunk %d: %d triggers, expected the "
             "planted event only" % (b, len(idx)))
        need(int(idx[0]) == i64, "phase C chunk %d trigger at %d, oracle "
             "argmax %d" % (b, idx[0], i64))
        err = abs(float(ds_at[0]) - float(ds64[i64]))
        errs.append(err)
        need(err <= 2e-5, "phase C chunk %d DS err %g" % (b, err))
        need(sl_at is not None and np.isfinite(sl_at).all() and sl_at[0] > 1,
             "phase C chunk %d STA/LTA %s" % (b, sl_at))
    best = min(times[1:])
    rate = B * hours / 24.0 / best
    say("phase C: s/batch (scan + re-verify) %s (best %.6f), dense "
        "station-days/s %.3f = %.4f of phase A's %.3f; planted DS err vs "
        "float64 oracle %s"
        % ([round(t, 6) for t in times[1:]], best, rate, rate / rate_a,
           rate_a, ["%.2e" % e for e in errs]))
    return dict(X=X[torch.as_tensor(planted, device=dev)], bank=bank,
                s_per_batch=best, station_days_per_s=rate,
                oracle_err=max(errs))


def dense_anatomy(dev, pc):
    """The re-verify's three kernels held against their twins on phase C's
    own re-verify inputs (the planted chunks, outside the counted run) and
    timed beside them and beside the one PyTorch call that computes the
    same function, where there is one."""
    X, bank = pc.pop("X"), pc["bank"]
    t0 = time.perf_counter()
    tds.run_bank_triggers_batch(
        None, bank, NC, [[0]] * X.shape[0], [[0.3]] * X.shape[0],
        [SR] * X.shape[0], 5.0, 0.0, True, max_triggers=4096, x_dev=X,
        lens_dev=[X.shape[1]] * X.shape[0])
    torch.cuda.synchronize()
    reverify_s = time.perf_counter() - t0
    res = dense_vs_twin(X, bank, [X.shape[1]] * X.shape[0], timing=True)
    say("phase C anatomy (re-verify of %d chunks, %.6f s host clock): %s "
        "(SM clock %s)" % (X.shape[0], reverify_s, "; ".join(
            "%s kernel %.3f ms, twin %.3f ms, library call %s ms"
            % (k, v["ms"], v["plain_ms"],
               "%.3f" % v["library_ms"] if "library_ms" in v else "-")
            for k, v in res.items()), sm_clock()))
    return res


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
    B, S, D = nv.shape[0], int(bank["sum_u"].shape[0]), int(bank["Dmax"])
    m = Fr.shape[1] // dft.half_rp(blk)
    spectra = 2 * Fr.numel() * 4
    stats = 2 * a.numel() * 4
    out["fwd_prep_fold"]["bound"] = bound(
        B * NC * (m * W + D0) * 4 + spectra + stats,
        B * NC * m * rfft_flops(blk))
    M = blk // 2
    out["spec_ds_fold"]["bound"] = bound(
        2 * ur.numel() * 4 + spectra + stats + B * S * m * (W // 128) * 4
        + B * S * NBIN * 4,
        B * S * m * D * (NC * (M + 1) * 8 + rfft_flops(blk) + 3 * W))
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
        if ("entry function" in line or "registers" in line
                or "spill" in line):
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
    say("phase 2: dense re-verify kernels vs twins, small test geometry "
        "and blk 32768")
    checks += [dense_vs_twin(*dense_case(dev, 4, 3 * 35000, 1680, 2, 3, 21)),
               dense_vs_twin(*dense_case(dev, 3, 3 * 200000, 3 * 16300, 1, 2,
                                         22, block_fft=32768))]
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

    tscan.ROUTE_COUNTS.clear()
    launches = {}

    def counted(phase, fn, *args):
        ck.reset_launches()
        out = fn(*args)
        launches[phase] = dict(ck.LAUNCHES)
        return out

    pa = counted("A", phase_a, dev)
    with tempfile.TemporaryDirectory() as tmp:
        counted("B", phase_b, dev, tmp)
    pc = counted("C", phase_c, dev, pa["station_days_per_s"])
    routes = dict(tscan.ROUTE_COUNTS)
    say("main-path launches by phase: %s; routes %s" % (launches, routes))
    for phase, ks in (("A", ("fwd_prep_fold", "spec_ds_fold")),
                      ("B", ("fwd_prep_fold", "spec_ds_fold")),
                      ("C", tuple(KERNEL_INFO))):
        for k in ks:
            need(launches[phase][k] > 0,
                 "kernel %s did not run on phase %s" % (k, phase))
    need(routes.get("fused-sub+fusedprep", 0) > 0
         and routes.get("fused-net+fusedprep", 0) > 0,
         "main path did not take the fused routes: %s" % routes)
    times = anatomy(dev, pa)
    times.update(dense_anatomy(dev, pc))

    # ms / plain_ms / library_ms / bound_ms: kernel, twin and the PyTorch
    # call computing the same function, at phase A's full shape (scan
    # kernels) and at phase C's re-verify shape (dense kernels)
    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        bound_ms, bound_by = times[k]["bound"]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=sum(launches[p][k] for p in launches),
            max_abs_err=max(r[k]["err"] for r in checks + [times] if k in r),
            ms=times[k]["ms"], plain_ms=times[k]["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=times[k].get("library_ms")))
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
