#!/usr/bin/env python3
"""
Smoke run of detex_torch on one NVIDIA GPU of compute capability 9.0 (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch twin on the card (the scan kernels at the
small test geometry, at blk 32768, at phase A's geometry cut to 16 chunks,
at phase B's shape, at one thread block of work and under one wave of the
card at both block lengths and, after the main-path run, at phase A's
full shape;
the dense re-verify kernels at the small geometry, at blk 32768 and, after
the main-path run, at phase C's re-verify shape; the per-chunk kernels and
rfft_ct_half at phase D's shapes, before phase D's runs, the per-chunk
finalize ds_finalize_os_scan timed with and without its histogram,
ds_finalize_os also in its general form (D = 5) and on one thread block;
the two forward transforms also on one row, under one wave of the card, at
n = 32768 and reading overlapping frames in place; the inverse transform at the
per-chunk route's shapes, on one row and under one wave), then drives the
port's paths through the entry points a user calls:

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
           oracle's argmax with its DS within 2e-5;
  phase D  every overlap-save route below the fused one, at 100 Hz on
           three channels with events planted and checked against the
           float64 oracle (one trigger at its argmax, DS within 2e-5, no
           trigger without an event):
           D1  128 detectors of 60 s templates (blk 32768, W 26752) served
               on 32 chunks of 3720 s: route "plain" with ds_finalize_os
               and hist_uniform; then ops/ds.run_bank and run_bank_rows on
               one chunk;
           D2  a 128-detector artifact of 30 s templates (phase B's
               shape) served on 64 chunks, whose DS array exceeds the fused
               route's cap: route "plain" with
               ds_finalize_os_scan and its histogram;
           D3  one 4-dim subspace of 90 s templates with the block pinned
               at 16384 (n_c > W) on 16 two-hour chunks: route "fused-sub",
               the unfused prep with rfft_ct_half;
           D4  small: non-uniform bins (route "plain" without the fused
               histogram) and a blk-8192 bank (route "fold" with torch.fft
               and ds_finalize_os_fold), each against the CPU twins;
  phase E  the device prep and the full-length and multiplexed banks, at
           published widths (3 channels, raw 100 Hz, hour chunks of 3720 s),
           planted events checked against the float64 oracle (prep_numpy,
           then ds_numpy) as in phase D:
           E1  devicePrep serving: a 128-detector artifact of 30 s
               templates at 50 Hz with filt [1, 10, 2, true] and decimate
               2, serving.scan_station_raw on raw [8, 3, 372000] chunks:
               route "fused-net+fusedprep+devicePrep";
           E2  a full-length demuxed bank of 16 x 4 (the ladders' rungs)
               of 30 s at 100 Hz from build_bank(prefer_os=False) on 8
               chunks: route "plain" with ds_finalize and hist_uniform,
               then run_bank, run_bank_rows and run_bank_batch;
           E3  E2's bank shape at 50 Hz, scan_chunks_raw on raw
               [8, 3, 372000] chunks at decimate 2, one ragged: route
               "raw-demux+devicePrep" with ds_finalize; then run_bank_raw;
           E4  small: a multiplexed bank (run_bank, scan_chunks), the
               raw path with the complex filter response at decimate 2 and
               scan_chunks_raw on a full-length bank of 129 templates (two
               template blocks), each against the CPU twins; ds_finalize
               against its twin at E2's shape before the counted runs;
  phase F  the detection engine, detect.detex, on seeded three-channel
           chunks of 3720 s at 100 Hz, its SQLite rows held against the
           float64 oracle (ds_numpy + extract_triggers_np on each planted
           chunk prepped as the engine preps it: STMP exact, DS within
           2e-5, no row without a planted event, histogram totals exact):
           F1  one station-day (24 chunks) of a station of 8 subspace
               detectors (30 s, D = 4) and one of 8 single templates, six
               planted events each, batchSize 8, histograms, magnitudes,
               STA/LTA: route "fused-net+fusedprep", the dense re-verify;
               station-days/s end to end, on chunks made before the
               clock starts (F2 and F3 time their runs the same way);
           F2  the bench.py network station: 1000 single templates (1024
               rows, 8 template blocks) on 8 chunks, four planted events:
               route "blocked-fused-net+fusedprep"; then the same bank's
               summary scan against its eight blocks of 128 through the
               unblocked route, histograms and maxima bit for bit;
           F3  devicePrep: a station of F1's subspace shape at 50 Hz on
               raw 100 Hz chunks, filt [1, 10, 2, true], decimate 2: route
               "fused-net+fusedprep+devicePrep", its rows held against the
               same engine's host-filter rows.
  phase G  detector construction (construct.py, subspace.py, fas.py) on
           seeded template waveforms: two stations of 220 events (20
           sources of 10 events at planted onset shifts, 20 singles), 130
           s at 100 Hz on 3 channels (trim [10, 120]):
           G1  bench.py cluster's geometry: ops/xcorr.xcorr_all_pairs on
               2 x 220 x 39,000 multiplexed samples (24,090 pairs a
               station, polyphase path), timed after one warm-up call;
               256 pairs and a small full-path case (n % 3 != 0) against
               the float64 oracle of _CCX2 (cc within 2e-5, lags exact
               where the peak is clear);
           G2  createCluster (CCreq 0.5) -> createSubSpace (dtype single)
               -> attachPickTimes (defaultDuration 30) -> SVD (selectCriteria
               2, selectValue 0.9, useSingles, FAS on G_CON_DAT_NUM null
               chunks of 3720 s a station) -> SubSpace.detex over one
               station-day with planted repeats of three sources and a
               single; wall seconds per stage, FAS's device-busy share;
               every source one cluster and every single single, alignment
               delays the planted shifts to one channel sample, thresholds
               in (0, 1), one detector's beta fit against the fit of the
               float64 oracle DS (ds_numpy) of the same null chunks within
               1e-3 relative, the SQLite rows against the float64 oracle
               as phase F holds them.
  phase H  the Case1 pipeline through the key-file entry points a user
           calls: the port's SynthCatalog writes template, station, phase
           and verification keys and two npz directories with their
           .index.db, then createCluster(fetch_arg=...) -> createSubSpace(
           conDatFetcher=DataFetcher("dir")) -> attachPickTimes -> SVD with
           FAS on fetched null chunks -> detex over the fetched hour files
           -> detResults (association, verification):
           H1  at tests/conftest.py's synth_case parameters, at dtype
               double and single, held against detex_tpu's record of the
               same dtype (tests/data/case1_reference.json, from
               scripts/record_case1_reference.py): clusters, delays and
               NumBasis identical, lags identical or near ties of the
               float64 oracle (printed), thresholds within 1e-5
               relative, every row's STMP exact and DS within 2e-5, every
               hidden event verified inside its window;
           H2  the path at full width: 2 stations x 48 h of 100 Hz
               three-channel hour files (3720 s), 4 sources of 5 events, 2
               singles and 6 hidden repeats, construction at dtype single
               (conDatNum 12), detex, detResults and writeDetections; wall
               seconds per stage (directory write, index, each
               construction stage, FAS, detex with its disk reads,
               detResults); every hidden event verified, the verified
               rows against the float64 oracle, a waveform file for every
               station of every new detection and the new template key.
           Every kernel the phase launches is held against its twin on the
           inputs of its first launch in H1 double, H1 single and H2.
  phase I  several devices, on a mesh of every CUDA device, or of cuda:0
           four times over on one card (which runs the sharded code with
           nothing to gain):
           I1  the sharded scans against the unsharded scans of the same
               inputs: phase A's 256 chunks (resident on cuda:0, and from a
               host array; timed, station-days/s both ways), an odd batch
               of 7 with triggers (padded to the mesh), F2's 1000-template
               station, E1's raw batch and E3's raw-demux batch; both routes
               printed; histograms, trigger counts and indices equal,
               maxima bit for bit where the routes agree, else within 1e-6;
           I2  F1's station-day through detect.detex on the mesh and with
               DETEX_TORCH_MESH=0: identical SQLite rows and histograms;
           I3  serving.export_detectors of H2's SubSpace, load_detectors,
               scan_station on eight of its hours with and without the
               mesh, held as I1 holds its cases;
           I4  H2's first station's 48 hour files written again as
               miniSEED and read back sample for sample, that directory
               indexed and scanned by SubSpace.detex with H2's rows, one
               hour of integer counts through STEIM2 and STEIM1 bit for
               bit; write and read MB/s.
           With several cards, B1, B2, B6, B7 and B10 are held against
           their twins on the last one.
  phase J  the engine's classify and UTC-save modes on the per-chunk path
           (ops/ds.run_bank: rfft_ct_fused, irfft_ct_fused,
           ds_finalize_os), saved objects and quality_check, on H2's
           objects at full width:
           J1  SubSpace.detex(classifyEvents=<H2's template key>) over both
               stations: one EventCors_<sta>.pkl a station, a row for each
               (event, subspace), each row's DS within 2e-5 of the float64
               oracle on the same multiplexed event chunk, every training
               event above 0.8 on its own subspace;
           J2  utcSaves at the hidden events' times: each saved row spans
               its time, its MPcon is the host multiplex of its hour, its
               SSdetect within 2e-5 of the float64 oracle with the argmax
               at the oracle's (or a near tie, printed); classify and
               utcSaves with a 5 s template buffer cut every DS vector by
               int((duration - 5) * sr) samples;
           J3  H2's detex at batchSize 1 against H2's batched rows (same
               rows, STMP exact, DS within 2e-5), then trigCon 1 at
               batchSize 1 (every DS_STALTA above the threshold, every
               hidden event among the rows); station-hours/s of each run;
           J4  ClusterStream.write -> util.loadClusters ->
               createSubSpace(clust=path) equal to the in-memory call,
               SubSpace.write -> util.loadSubSpace, whose detex over eight
               hours of one station gives the original's rows; a pickle
               naming a detex_tpu class refused without importing it;
           J5  quality_check.check_data_quality on H2's continuous
               directory: every file passes.
           Every kernel the phase launches is held against its twin on the
           inputs of its first launch.
  phase K  the Case1 path on automatic picks, on H2's hour files and
           cluster at full width (dtype single):
           K1  util.autoPickPhases over H2's event directory (44 station /
               event streams): the picks' distance to H2's phase file
               printed (median, largest); the file read back by
               attachPickTimes on a fresh SubSpace, every detector with a
               picked event trimmed;
           K2  createSubSpace -> autoPickTimes(duration=30) in place of
               attachPickTimes -> SVD with FAS at H2's settings -> detex
               over all 96 station-hours -> detResults: every hidden event
               that H2 verified verified again, the verified rows' DS
               within 2e-5 of the float64 oracle; stage seconds and the
               detex's station-hours/s beside H2's.
           Every kernel the phase launches is held against its twin on the
           inputs of its first launch.

``python3 chip_smoke.py --phases I`` builds the kernels and the native
library and runs phase H2 (phase I's SubSpace and hour files), phase I
and the holds on the last card alone, for a four-card machine.
``--phases J`` runs phase H2 and phase J alone, ``--phases K`` phase H2
and phase K.

Each phase runs with the kernels' launch counts set to 0 just before it
and read just after. Data and weights are random from fixed seeds. Every
phase's failure raises; the run exits 0 only when all pass. The last lines
are the kernels' JSON record, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": {...}}. Each kernel's record
counts its launches over every phase ("launches"), over the engine's
phases F1-F3 ("engine_launches"), over the construction phases G1-G2
("construct_launches"), over the key-file pipeline H1-H2
("pipeline_launches"), over phase I ("mesh_launches"), over phase J
("modes_launches") and over phase K ("picks_launches").
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
from detex_torch.ops import prep as tprep
from detex_torch.ops import reference as ref
from detex_torch.ops import triggers as ttrig
from detex_torch.parallel import mesh as tmesh
from detex_torch.parallel import scan as tscan
from detex_torch import construct, detect, fas, native, serving, util
from detex_torch.ops import xcorr
from detex_torch.core import Stream, Trace
from detex_torch.core.utc import UTCDateTime

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
    "rfft_ct_half": ("detex_torch/kernels/rfft_ct_half.cu",
                     "detex_tpu/ops/pallas_kernels.py:1223"),
    "ds_finalize_os_scan": ("detex_torch/kernels/ds_finalize_os_scan.cu",
                            "detex_tpu/ops/pallas_kernels.py:438"),
    "ds_finalize_os": ("detex_torch/kernels/ds_finalize_os.cu",
                       "detex_tpu/ops/pallas_kernels.py:701"),
    "hist_uniform": ("detex_torch/kernels/hist_uniform.cu",
                     "detex_tpu/ops/pallas_kernels.py:199"),
    "ds_finalize": ("detex_torch/kernels/ds_finalize.cu",
                    "detex_tpu/ops/pallas_kernels.py:104"),
}
DENSE_KERNELS = ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os_fold")
# launches per timing of the kernels that take under 0.35 ms (the block
# transforms, the finalize kernels, the histogram): a mean of 3 would hold
# the first launch's start-up
SHORT_REPS = 20
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


def graph_ms(fn, reps=50):
    """Mean device milliseconds of fn() without the host's launch cost:
    CUDA events around one replay of a CUDA graph of ``reps`` calls. For
    shapes under one wave of the card, where cuda_ms would time the host's
    launch rate."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def short_ms(fn):
    """cuda_ms over SHORT_REPS launches."""
    return cuda_ms(fn, reps=SHORT_REPS)


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


def scan_extras(dev):
    """fwd_prep_fold and spec_ds_fold beyond the main path's shapes: at one
    thread block of work and under one wave of the card's 132 SMs, at blk
    16384 and at blk 32768 (n_c 16300), each held against its twin first,
    spec_ds_fold in both row orders with and without the DS array. Timed
    by CUDA-graph replay: events around single launches this short would
    time the host's launch rate."""
    res = {"fwd_prep_fold": dict(err=0.0), "spec_ds_fold": dict(err=0.0)}
    cases = (("one block", 1, 3 * 8000, 1680, 1, 1, None),
             ("one block", 1, 3 * 30000, 3 * 16300, 1, 2, 32768),
             ("under one wave", 20, 3 * 35000, 1680, 2, 3, None),
             ("under one wave", 4, 3 * 200000, 3 * 16300, 2, 1, 32768))
    for tag, B, Lc, n, S, D, block_fft in cases:
        rng = np.random.default_rng(B + n)
        n_c, L_c = n // NC, Lc // NC
        bank = tds.build_bank([basis(rng, D, n) for _ in range(S)], NC, Lc,
                              dev, block_fft=block_fft)
        blk = bank["blk_fft"]
        out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
        g = torch.Generator(device=dev).manual_seed(B + n)
        xq = torch.zeros((B, NC, m * W + D0), dtype=torch.float32, device=dev)
        xq[:, :, pad0:pad0 + L_c] = torch.randn((B, NC, L_c), generator=g,
                                                device=dev)
        nv = torch.full((B,), out_len, dtype=torch.int32, device=dev)
        if L_c // 2 > n_c:                           # ragged last chunk
            xq[-1, :, pad0 + L_c // 2:] = 0.0
            nv[-1] = L_c // 2 - n_c + 1
        p = compare_prep(xq, n_c, blk, out_len)
        Fr, Fi, a, power = p["prep"]
        ur, ui = tds.bank_spec_pair(bank)
        su = bank["sum_u"].T.contiguous()
        err = 0.0
        for mode in ("sub", "net"):
            args = (ur, ui, Fr, Fi, a, power, su, nv, mode, NC, W, D0, blk)
            for emit_ds in (True, False):
                err = max(err, compare_spec(args, emit_ds)["err"])
        prep_ms = graph_ms(lambda: ck.fwd_prep_fold(xq, NC, n_c, blk,
                                                    out_len))
        spec_ms = graph_ms(lambda: ck.spec_ds_fold(*args, nbin=NBIN,
                                                   emit_ds=False))
        res["fwd_prep_fold"]["err"] = max(res["fwd_prep_fold"]["err"],
                                          p["err"])
        res["spec_ds_fold"]["err"] = max(res["spec_ds_fold"]["err"], err)
        say("  %s, blk %d: fwd_prep_fold %d frames x %d channels, spectra "
            "max_abs_err %.3g, %.4f ms; spec_ds_fold %d transforms (sub, "
            "net; DS array on, off), max_abs_err %.3g, summary-only %.4f ms "
            "[graph replay]"
            % (tag, blk, B * m, NC, p["err"], prep_ms, B * S * D * m, err,
               spec_ms))
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
        out["ms"] = short_ms(lambda: ck.rfft_ct_fused(frames, blk))
        out["plain_ms"] = short_ms(
            lambda: ref.rfft_ct_fused_ref(frames, blk))
        out["library_ms"] = short_ms(lambda: torch.fft.rfft(frames, n=blk))
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
        out["ms"] = short_ms(lambda: ck.irfft_ct_fused(spec, blk))
        out["plain_ms"] = short_ms(
            lambda: ref.irfft_ct_fused_ref(spec, blk))
        out["library_ms"] = short_ms(lambda: torch.fft.irfft(spec, n=blk))
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
        out["ms"] = short_ms(lambda: ck.ds_finalize_os_fold(*fin, nbin=nbin))
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

def phase_a_inputs(dev, B=256, hours=2.0, seed=1):
    """Phase A's bank (one 4-dim basis of 30 s templates) and its B chunks
    of ``hours`` on the card with three events planted: (X, bank, U,
    planted, out_len)."""
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
    return X, bank, U, planted, out_len


def phase_a(dev, B=256, hours=2.0, seed=1):
    X, bank, U, planted, out_len = phase_a_inputs(dev, B, hours, seed)
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

SERVE_STA = "XX.S01"


def serving_setup(dev, tmpdir, tag, S, B, seconds, seed, amp=None):
    """A station of S single-template detectors of ``seconds`` s written in
    detex_tpu's export_detectors schema and loaded with
    serving.load_detectors (3600 s chunks, 120 s buffer), plus B 3720 s
    chunks with four events planted (amplitude ``amp``, default 150)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR * NC)
    sta = SERVE_STA
    Us = [basis(rng, 1, n) for _ in range(S)]
    meta = {"stations": {sta: {"nc": NC, "sr": SR, "detectors": [
        dict(name="SG%03d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%03d" % s]) for s in range(S)]}},
        "filt": [1.0, 10.0, 2, True], "decimate": 1, "version": 1}
    arrays = {"U__%s__SG%03d" % (sta, s): Us[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = os.path.join(tmpdir, "detectors_%s.npz" % tag)
    np.savez(path, **arrays)
    dep = serving.load_detectors(path, chunk_sec=3600, conBuff=120,
                                 device=dev)
    Lc = int(3720 * SR * NC)
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    # (chunk, detector, channel-aligned offset)
    planted = [(0, 3 % S, Lc // 24 * 3), (2 % B, 77 % S, Lc // 6 * 3),
               (5 % B, 127 % S, Lc * 3 // 10 * 3), (B - 1, 40 % S, 33)]
    amp = 150.0 if amp is None else amp
    for b, s, off in planted:
        X[b, off:off + n] += amp * Us[s][0].astype(np.float32)
    return dict(dep=dep, X=X, Us=Us, planted=planted, n=n,
                bank=dep[sta]["banks"][0])


def serve_and_check(tag, su, max_trig=16):
    """serving.scan_station on the setup's chunks, three times (the first
    warms up); every planted event triggers at the float64 oracle's argmax
    with its DS within 2e-5, and no other row triggers."""
    X, Us, planted, n = su["X"], su["Us"], su["planted"], su["n"]
    B, Lc = X.shape
    S = len(Us)
    say("phase %s: %d detectors, B=%d chunks x %d samples, blk %d"
        % (tag, S, B, Lc, su["bank"]["blk_fft"]))
    times = []
    for _ in range(3):                              # first run warms up
        t0 = time.perf_counter()
        res = serving.scan_station(su["dep"], SERVE_STA, X,
                                   max_trig=max_trig)
        times.append(time.perf_counter() - t0)
    r = res[0]
    need(r["maxds"].shape == (B, S) and np.isfinite(r["maxds"]).all(),
         "phase %s maxds not finite [B, S]" % tag)
    nv = (Lc - n) // NC + 1
    need(np.array_equal(r["hist"].sum(axis=1), np.full(S, B * nv)),
         "phase %s histogram totals off" % tag)
    errs = []
    for b, s, off in planted:
        ds64 = tds.ds_numpy(X[b].astype(np.float64), Us[s], NC)
        i64 = int(np.nanargmax(ds64))
        need(r["trig_count"][b, s] >= 1, "phase %s event (%d, %d) missed"
             % (tag, b, s))
        need(int(r["trig_idx"][b, s, 0]) == i64,
             "phase %s event (%d, %d) at %d, oracle argmax %d"
             % (tag, b, s, r["trig_idx"][b, s, 0], i64))
        err = abs(float(r["trig_val"][b, s, 0]) - float(ds64[i64]))
        errs.append(err)
        need(err <= 2e-5, "phase %s event DS err %g" % (tag, err))
    hits = {(b, s) for b, s, _ in planted}
    extra = [(b, s) for b in range(B) for s in range(S)
             if r["trig_count"][b, s] and (b, s) not in hits]
    need(not extra, "phase %s rows without a planted event triggered: %s"
         % (tag, extra[:8]))
    best = min(times[1:])
    say("phase %s: s/request %s (best %.6f), planted DS err vs float64 "
        "oracle %s, other triggered rows %d"
        % (tag, [round(t, 6) for t in times[1:]], best,
           ["%.2e" % e for e in errs], len(extra)))
    return dict(s_per_request=best, oracle_err=max(errs))


def phase_b(dev, tmpdir, S=128, B=8, seed=2):
    return serve_and_check("B", serving_setup(dev, tmpdir, "b", S, B, 30.0,
                                              seed))


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


# ---------------------------------------------------------------------------
# phase D: the per-chunk routes and the fused scan's unfused prep
# ---------------------------------------------------------------------------

def chunk_finalize_inputs(bank, x):
    """One chunk's per-chunk finalize inputs, made as ops/ds._os_block
    makes them (on the card's transform kernels): (cb [S*D, m, blk],
    a, power [m*W] padded and power-safe, sum_u [S*D], D0, D, W,
    out_len)."""
    n_c, blk, D = bank["n_c"], bank["blk_fft"], int(bank["Dmax"])
    L_c = x.shape[0] // NC
    out_len, _, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    F, a, power = tds.os_prep(x, n_c, NC, blk)
    spec = sum(bank["Ufd2"][:, :, c, None, :] * F[c][None, None]
               for c in range(NC))
    cb = dft.irfft_ct(spec, blk).reshape(-1, m, blk)
    del spec
    ap, pp = tds._pad_stats(a, power, out_len, m * W)
    su = torch.where(bank["d_mask"], bank["sum_u"],
                     torch.zeros_like(bank["sum_u"])).reshape(-1)
    return cb, ap, pp, su.contiguous(), D0, D, W, out_len


def finalize_bound(fin, maxima, nbin):
    """bound() of a per-chunk finalize: read D*W floats of cb, the two
    stats rows and sum_u, write the DS rows (and the block maxima and
    counts); 3D + 1 operations a sample."""
    cb, a, _, su, _, D, W, _ = fin
    S, m = cb.shape[0] // D, cb.shape[1]
    samples = S * m * W
    return bound(samples * D * 4 + 2 * a.numel() * 4 + su.numel() * 4
                 + samples * 4 + (samples // 128 * 4 if maxima else 0)
                 + S * nbin * 4, samples * (3 * D + 1))


def compare_half(frames, blk):
    k = ck.rfft_ct_half(frames, blk)
    r = ref.rfft_ct_half_ref(frames, blk)
    torch.cuda.synchronize()
    R = blk // 2 + 1
    err = max((a[:, :R] - b[:, :R]).abs().max().item()
              for a, b in zip(k, r))
    need(all(bool((a[:, R:] == 0).all()) for a in k),
         "rfft_ct_half spectra past blk/2 not zero")
    need(err <= 2e-3, "rfft_ct_half spectra err %g > 2e-3" % err)
    del k, r
    N = frames.shape[0]
    return dict(
        err=err, ms=short_ms(lambda: ck.rfft_ct_half(frames, blk)),
        plain_ms=short_ms(lambda: ref.rfft_ct_half_ref(frames, blk)),
        library_ms=short_ms(lambda: torch.fft.rfft(frames, n=blk)),
        bound=bound(N * blk * 4 + 2 * N * dft.half_rp(blk) * 4,
                    N * rfft_flops(blk)))


def forward_extras(dev):
    """rfft_ct_fused (B4) and rfft_ct_half (B6) beyond the shapes of the
    ``kernels`` line, each held against its twin first (spectra 2e-3, B6's
    zeros past blk/2 exact) and timed beside torch.fft.rfft: one row; the
    per-chunk route's 84 rows of 16,384 (D2) and 42 rows of 32,768 (D1),
    under one wave of the card and so timed by graph replay; n = 32768 at
    648 and 2,352 rows; and the framed form the paths use (overlapping
    frames read in place from the padded demuxed batch) at phase C's
    re-verify shape, D3's shape and one D1 chunk, beside contiguous() +
    torch.fft.rfft of the same view."""
    g = torch.Generator(device=dev).manual_seed(77)
    errs = {"rfft_ct_fused": 0.0, "rfft_ct_half": 0.0}

    def held(name, got, rows, blk):
        R = blk // 2 + 1
        if name == "rfft_ct_fused":
            err = (got - ref.rfft_ct_fused_ref(rows, blk)).abs().max().item()
        else:
            want = ref.rfft_ct_half_ref(rows, blk)
            got = [a.reshape(-1, dft.half_rp(blk)) for a in got]
            err = max((a[:, :R] - b[:, :R]).abs().max().item()
                      for a, b in zip(got, want))
            need(all(bool((a[:, R:] == 0).all()) for a in got),
                 "rfft_ct_half spectra past blk/2 not zero")
        torch.cuda.synchronize()
        need(err <= 2e-3, "%s spectra err %g > 2e-3" % (name, err))
        errs[name] = max(errs[name], err)
        return err

    for name, N, blk in (("rfft_ct_fused", 1, 16384),
                         ("rfft_ct_fused", 84, 16384),
                         ("rfft_ct_fused", 42, 32768),
                         ("rfft_ct_fused", 648, 32768),
                         ("rfft_ct_half", 1, 32768),
                         ("rfft_ct_half", 2352, 32768)):
        x = torch.randn((N, blk), generator=g, device=dev)
        fn = getattr(ck, name)
        err = held(name, fn(x, blk), x, blk)
        timer = graph_ms if N < 132 else short_ms
        out_bytes = (N * (blk // 2 + 1) * 8 if name == "rfft_ct_fused"
                     else N * dft.half_rp(blk) * 8)
        say("  %s %d x %d: max_abs_err %.3g; kernel %.4f ms, torch.fft.rfft "
            "%.4f ms, bound %.4f ms%s"
            % (name, N, blk, err, timer(lambda: fn(x, blk)),
               timer(lambda: torch.fft.rfft(x, n=blk)),
               bound(N * blk * 4 + out_bytes, N * rfft_flops(blk))[0],
               " (graph replay of 50)" if N < 132 else ""))
        del x
    L_c = int(7200 * SR)
    for name, tag, B, L, n_c, blk in (
            ("rfft_ct_fused", "C's re-verify", 8, L_c, 3000, 16384),
            ("rfft_ct_half", "D3", 16, L_c, 9000, 16384),
            ("rfft_ct_fused", "one D1 chunk", 1, int(3720 * SR), 6000,
             32768)):
        _, _, D0, W, m = tds._os_geometry(L, n_c, blk)
        xq = torch.randn((B, NC, m * W + D0), generator=g, device=dev)
        if name == "rfft_ct_fused":
            fn = lambda: dft.rfft_frames(xq, blk, W, m)
        else:
            fn = lambda: dft.rfft_pair_frames(xq, blk, W, m,
                                              dft.half_rp(blk))
        before = ck.LAUNCHES[name]
        got = fn()
        need(ck.LAUNCHES[name] == before + 1, "%s framed: not one launch"
             % name)
        rows = xq.unfold(2, blk, W).reshape(-1, blk)
        err = held(name, got.reshape(-1, blk // 2 + 1)
                   if name == "rfft_ct_fused" else got, rows, blk)
        del got, rows
        timer = graph_ms if B * NC * m < 132 else short_ms
        say("  %s framed (%s): %d frames of %d at stride %d in %d rows: "
            "max_abs_err %.3g; kernel, frames read in place %.4f ms; "
            "contiguous() + torch.fft.rfft %.4f ms; kernel on the copied "
            "frames %.4f ms + the copy %.4f ms"
            % (name, tag, B * NC * m, blk, W, B * NC, err, timer(fn),
               timer(lambda: torch.fft.rfft(
                   xq.unfold(2, blk, W).contiguous(), n=blk)),
               timer(lambda r=xq.unfold(2, blk, W).reshape(-1, blk):
                     getattr(ck, name)(r, blk)),
               timer(lambda: xq.unfold(2, blk, W).contiguous())))
        del xq
    return {k: dict(err=v) for k, v in errs.items()}


def inverse_extras(dev):
    """irfft_ct_fused (B5) beyond phase C's re-verify shape of the
    ``kernels`` line, each held against its twin first (2e-5 of each row's
    largest value; an all-zero row exactly 0) and timed beside
    torch.fft.irfft and its bound: the per-chunk route's rows, 3,584 of
    16,384 (one D2 chunk: 128 templates x 28 blocks) and 1,792 of 32,768
    (one D1 chunk: 128 x 14); one row and under one wave of the card (84
    rows of 16,384, 42 of 32,768), timed by graph replay."""
    g = torch.Generator(device=dev).manual_seed(78)
    err = 0.0
    for N, blk in ((1, 16384), (84, 16384), (3584, 16384), (1, 32768),
                   (42, 32768), (1792, 32768)):
        spec = torch.view_as_complex(torch.randn(
            (N, blk // 2 + 1, 2), generator=g, device=dev))
        # real end bins, as every caller's spectra have them (cuFFT's C2R,
        # the twin on the card, does not promise to ignore their imaginary
        # parts; the kernel does)
        torch.view_as_real(spec)[:, [0, -1], 1] = 0.0
        if N > 1:
            spec[N // 2] = 0
        k = ck.irfft_ct_fused(spec, blk)
        r = ref.irfft_ct_fused_ref(spec, blk)
        torch.cuda.synchronize()
        scale = r.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        rel = ((k - r).abs() / scale).max().item()
        need(rel <= 2e-5, "irfft_ct_fused %d x %d err %g of the row max > "
             "2e-5" % (N, blk, rel))
        if N > 1:
            need(bool((k[N // 2] == 0).all()),
                 "irfft_ct_fused zero row not exactly 0")
        err = max(err, (k - r).abs().max().item())
        del k, r
        timer = graph_ms if N < 132 else short_ms
        ms = timer(lambda: ck.irfft_ct_fused(spec, blk))
        lib = timer(lambda: torch.fft.irfft(spec, n=blk))
        bnd = bound(N * (blk // 2 + 1) * 8 + N * blk * 4,
                    N * rfft_flops(blk))[0]
        say("  irfft_ct_fused %d x %d: %.3g of the row max; kernel %.4f ms, "
            "torch.fft.irfft %.4f ms, bound %.4f ms%s"
            % (N, blk, rel, ms, lib, bnd,
               " (graph replay of 50)" if N < 132 else ""))
        del spec
    return {"irfft_ct_fused": dict(err=err)}


def compare_os_scan(fin, nv, nbin):
    args = fin[:4] + (nv,) + fin[4:7]
    dk, pk, hk = ck.ds_finalize_os_scan(*args, nbin=nbin)
    dr, pr, hr = ref.ds_finalize_os_scan_ref(*args, nbin=nbin)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in (("ds", dk, dr), ("pyr", pk, pr)):
        need(torch.equal(torch.isfinite(a), torch.isfinite(b)),
             "ds_finalize_os_scan %s -inf positions differ" % name)
        f = torch.isfinite(b)
        if f.any():
            err = max(err, (a[f] - b[f]).abs().max().item())
    need(err <= 2e-5, "ds_finalize_os_scan ds/pyr err %g > 2e-5" % err)
    moves = allowed = 0
    if nbin:
        need(torch.equal(hk.sum(1), hr.sum(1)), "histogram row totals differ")
        moves = int((hk - hr).abs().sum().item())
        allowed = max(int(hr.sum().item()) // 200000, 2)
        need(moves <= allowed, "histogram moves %d > %d" % (moves, allowed))
    del dk, pk, hk, dr, pr, hr
    return dict(
        err=err, moves=moves, allowed=allowed,
        ms=short_ms(lambda: ck.ds_finalize_os_scan(*args, nbin=nbin)),
        plain_ms=cuda_ms(lambda: ref.ds_finalize_os_scan_ref(
            *args, nbin=nbin)),
        bound=finalize_bound(fin, True, nbin))


def compare_os(fin):
    args = fin[:4] + fin[4:7]
    dk = ck.ds_finalize_os(*args)
    dr = ref.ds_finalize_os_ref(*args)
    torch.cuda.synchronize()
    need(bool(torch.isfinite(dk).all()), "ds_finalize_os not finite")
    err = (dk - dr).abs().max().item()
    need(err <= 2e-5, "ds_finalize_os err %g > 2e-5" % err)
    del dk
    out = dict(err=err, ms=short_ms(lambda: ck.ds_finalize_os(*args)),
               plain_ms=cuda_ms(lambda: ref.ds_finalize_os_ref(*args)),
               bound=finalize_bound(fin, False, 0))
    return out, dr


def os_extras(dev):
    """ds_finalize_os (B8) beyond one D1 chunk, each held against its twin
    (2e-5) and timed: the general form (D > 4: basis rows loaded four at a
    time), eight 5-dim subspaces of 60 s templates on a 3720 s chunk (cb
    [40, 14, 32768]); and one thread block of work, one 60 s template on a
    300 s chunk (cb [1, 1, 32768]: 209 groups of 128 over 8 warps)."""
    rng = np.random.default_rng(79)
    g = torch.Generator(device=dev).manual_seed(79)
    n = int(60 * SR * NC)
    err = 0.0
    for tag, Us, seconds in (("D5", [basis(rng, 5, n) for _ in range(8)],
                              3720),
                             ("one block", [basis(rng, 1, n)], 300)):
        Lc = int(seconds * SR * NC)
        bank = tds.build_bank(Us, NC, Lc, dev, block_fft=32768)
        fin = chunk_finalize_inputs(
            bank, torch.randn(Lc, generator=g, device=dev))
        r, _ = compare_os(fin)
        err = max(err, r["err"])
        say("  ds_finalize_os cb %s (%s): max_abs_err %.3g; kernel %.4f ms, "
            "twin %.3f ms, bound %.4f ms"
            % (tuple(fin[0].shape), tag, r["err"], r["ms"], r["plain_ms"],
               r["bound"][0]))
        del fin, bank
    return err


def compare_hist(v, nbin):
    hk = ck.hist_uniform(v, nbin)
    hr = ref.hist_uniform_ref(v, nbin)
    torch.cuda.synchronize()
    need(torch.equal(hk, hr), "hist_uniform counts differ from the twin")
    S, L = v.shape
    return dict(err=float((hk - hr).abs().max().item()),
                ms=short_ms(lambda: ck.hist_uniform(v, nbin)),
                plain_ms=cuda_ms(lambda: ref.hist_uniform_ref(v, nbin)),
                bound=bound(S * L * 4 + S * nbin * 4, S * L * 4))


def phase_d3_setup(dev, B=16, hours=2.0, seed=6):
    """One 4-dim subspace of 90 s templates (n_c 9000) with the block
    pinned at 16384 (W 7296 < n_c: the fused prep refuses, the fused scan
    kernel takes it behind the unfused prep), B two-hour chunks with three
    events planted at DS ~ 0.9."""
    rng = np.random.default_rng(seed)
    n = int(90 * SR * NC)
    Lc = int(hours * 3600 * SR * NC)
    U = basis(rng, 4, n)
    bank = tds.build_bank([U], NC, Lc, dev, block_fft=16384)
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, Lc), generator=g, device=dev)
    Ut = torch.as_tensor(U.astype(np.float32), device=dev)
    planted = [(1, Lc // 30 * 3, 0), (B // 2, Lc // 6 * 3, 1),
               (B - 3, Lc * 3 // 10 * 3, 3)]
    for b, off, d in planted:
        X[b, off:off + n] += 3.0 * np.sqrt(n) * Ut[d]
    return dict(X=X, bank=bank, U=U, planted=planted)


def phase_d_kernels(dev, d1, d2, d3):
    """B6-B9 held against their twins at phase D's shapes, outside the
    counted runs, and timed: rfft_ct_half on D3's frames, ds_finalize_os_scan
    (nbin NBIN and 0) on one D2 chunk, ds_finalize_os on one D1 chunk (and
    os_extras' shapes) and hist_uniform on its DS rows (-inf past the valid
    length, as os_block_scan masks them)."""
    res = {}
    X3, bank3 = d3["X"], d3["bank"]
    n_c, blk = bank3["n_c"], bank3["blk_fft"]
    _, _, _, W, _ = tds._os_geometry(X3.shape[1] // NC, n_c, blk)
    xq, _ = tds.standardize_demux(X3, n_c, NC, blk)
    frames = xq.unfold(2, blk, W).reshape(-1, blk).contiguous()
    del xq
    res["rfft_ct_half"] = compare_half(frames, blk)
    say("  rfft_ct_half blk %d (%d rows, D3): spectra max_abs_err %.3g"
        % (blk, frames.shape[0], res["rfft_ct_half"]["err"]))
    del frames
    fin = chunk_finalize_inputs(d2["bank"], torch.as_tensor(d2["X"][0],
                                                            device=dev))
    nv = torch.tensor([fin[-1]], dtype=torch.int32, device=dev)
    for nbin in (0, NBIN):
        r = compare_os_scan(fin, nv, nbin)
        say("  ds_finalize_os_scan cb %s nbin %d (D2): max_abs_err %.3g, "
            "hist moves %d (allowed %d); kernel %.4f ms, twin %.3f ms, bound "
            "%.4f ms" % (tuple(fin[0].shape), nbin, r["err"], r["moves"],
                         r["allowed"], r["ms"], r["plain_ms"],
                         r["bound"][0]))
        # the kernels line keeps nbin NBIN's times, the main path's
        agg = res.setdefault("ds_finalize_os_scan", dict(err=0.0))
        agg.update(r, err=max(agg["err"], r["err"]))
    fin = chunk_finalize_inputs(d1["bank"], torch.as_tensor(d1["X"][0],
                                                            device=dev))
    res["ds_finalize_os"], dr = compare_os(fin)
    pos = torch.arange(dr.shape[1], device=dev)
    v = torch.where(pos[None, :] < fin[-1], dr,
                    torch.full_like(dr, float("-inf")))
    cb_shape = tuple(fin[0].shape)
    del fin, dr
    res["hist_uniform"] = compare_hist(v, NBIN)
    say("  ds_finalize_os cb %s (D1): max_abs_err %.3g; hist_uniform %s: "
        "counts equal to the twin's" % (cb_shape, res["ds_finalize_os"]["err"],
                                        tuple(v.shape)))
    del v
    # the kernels line keeps the D1 chunk's times, the main path's
    res["ds_finalize_os"]["err"] = max(res["ds_finalize_os"]["err"],
                                       os_extras(dev))
    for k, r in res.items():
        say("  %s at phase-D shape: kernel %.3f ms, twin %.3f ms, library "
            "call %s ms, bound %.3f ms (%s) (SM clock %s)"
            % (k, r["ms"], r["plain_ms"],
               "%.3f" % r["library_ms"] if "library_ms" in r else "-",
               r["bound"][0], r["bound"][1], sm_clock()))
    return res


def phase_d1(dev, su):
    """D1: 128 detectors of 60 s templates served on 32 chunks (route
    "plain", ds_finalize_os + hist_uniform), then ops/ds.run_bank and
    run_bank_rows on the first chunk against the float64 oracle."""
    out = serve_and_check("D1", su)
    X, Us, bank = su["X"], su["Us"], su["bank"]
    (b, s, _), (_, s2, _) = su["planted"][:2]
    t0 = time.perf_counter()
    full = tds.run_bank(X[b], bank, NC)
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = tds.run_bank_rows(X[b], bank, NC, [s, s2])
    t_rows = time.perf_counter() - t0
    errs = []
    for r in (s, s2):
        ds64 = tds.ds_numpy(X[b].astype(np.float64), Us[r], NC)
        need(full.shape == (len(Us), len(ds64)), "run_bank shape %s"
             % (full.shape,))
        need(np.array_equal(rows[r], full[r]),
             "run_bank_rows row %d differs from run_bank's" % r)
        errs.append(float(np.abs(full[r] - ds64).max()))
        need(errs[-1] <= 2e-5, "run_bank row %d err %g vs float64 oracle"
             % (r, errs[-1]))
    need(int(np.argmax(full[s])) == int(np.nanargmax(
        tds.ds_numpy(X[b].astype(np.float64), Us[s], NC))),
        "run_bank planted argmax off")
    say("phase D1: run_bank %.6f s, run_bank_rows (2 rows) %.6f s (host "
        "clock); max err vs float64 oracle %s"
        % (t_bank, t_rows, ["%.2e" % e for e in errs]))
    out.update(run_bank_s=t_bank, oracle_err=max([out["oracle_err"]] + errs))
    return out


def phase_d3(dev, d3):
    """D3: scan_chunks of the 90 s subspace on 16 two-hour chunks (route
    "fused-sub": os_prep_batch_pair with rfft_ct_half, then spec_ds_fold),
    triggers on."""
    X, bank, U, planted = d3["X"], d3["bank"], d3["U"], d3["planted"]
    B = X.shape[0]
    th = np.full(1, 0.5, np.float32)
    say("phase D3: B=%d chunks x %d samples, 4-dim subspace n_c %d, blk %d"
        % (B, X.shape[1], bank["n_c"], bank["blk_fft"]))
    times = []
    for _ in range(3):                              # first run warms up
        t0 = time.perf_counter()
        out = tscan.scan_chunks(X, bank, th, NC, int(20 * SR), max_trig=8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    maxds, tidx, tval, tcnt = (t.cpu().numpy() for t in out[1:])
    errs = []
    for b, off, d in planted:
        ds64 = tds.ds_numpy(X[b].double().cpu().numpy(), U, NC)
        i64 = int(np.nanargmax(ds64))
        need(tcnt[b, 0] == 1 and int(tidx[b, 0, 0]) == i64,
             "phase D3 chunk %d: %d triggers, first at %d, oracle argmax %d"
             % (b, tcnt[b, 0], tidx[b, 0, 0], i64))
        errs += [abs(float(tval[b, 0, 0]) - float(ds64[i64])),
                 abs(float(maxds[b, 0]) - float(np.nanmax(ds64)))]
        need(max(errs[-2:]) <= 2e-5, "phase D3 chunk %d DS err %g"
             % (b, max(errs[-2:])))
    quiet = [b for b in range(B) if b not in {p[0] for p in planted}]
    need(not tcnt[quiet].any(), "phase D3 quiet chunks triggered")
    best = min(times[1:])
    say("phase D3: s/launch %s (best %.6f), station-days/s %.3f, planted DS "
        "err vs float64 oracle %s"
        % ([round(t, 6) for t in times[1:]], best,
           B * X.shape[1] / (SR * NC * 86400.0) / best,
           ["%.2e" % e for e in errs]))
    return dict(s_per_launch=best, oracle_err=max(errs))


def phase_d4(dev, seed=7):
    """D4, small: non-uniform bins (route "plain": ds_finalize_os_scan
    without its histogram, then the sort-and-search counts) and a
    blk-8192 bank of short chunks (route "fold": torch.fft transforms, then
    ds_finalize_os_fold), each scanned on the card and on the CPU twins."""
    rng = np.random.default_rng(seed)
    n = 1680                                        # 5.6 s templates
    Us = [basis(rng, 2, n) for _ in range(3)]
    errs = []
    for tag, L_c, blk, bins in (("bins", 120000, 16384,
                                 np.linspace(0, 1, 11) ** 2),
                                ("fold", 24000, 8192, None)):
        X = rng.standard_normal((4, NC * L_c)).astype(np.float32)
        X[1, NC * 9000:NC * 9000 + n] += 150.0 * Us[0][0].astype(np.float32)
        th = np.full(3, 0.6, np.float32)
        outs = []
        for d in (dev, "cpu"):
            bank = tds.build_bank(Us, NC, NC * L_c, d, block_fft=blk)
            outs.append([t.cpu() for t in tscan.scan_chunks(
                X, bank, th, NC, int(20 * SR), bins=bins, max_trig=8)])
        g, c = outs
        need(torch.equal(g[0].sum(1), c[0].sum(1)),
             "phase D4 %s histogram totals differ from the CPU's" % tag)
        moves = int((g[0] - c[0]).abs().sum().item())
        need(moves <= max(int(c[0].sum().item()) // 200000, 2),
             "phase D4 %s histogram moves %d" % (tag, moves))
        errs.append((g[1] - c[1]).abs().max().item())
        need(errs[-1] <= 2e-5, "phase D4 %s maxds err %g" % (tag, errs[-1]))
        need(torch.equal(g[2], c[2]) and torch.equal(g[4], c[4]),
             "phase D4 %s triggers differ from the CPU's" % tag)
        ds64 = tds.ds_numpy(X[1].astype(np.float64), Us[0], NC)
        need(int(g[4][1, 0]) == 1 and int(g[2][1, 0, 0]) ==
             int(np.nanargmax(ds64)), "phase D4 %s planted trigger" % tag)
        say("phase D4 %s (L_c %d, blk %d): maxds err vs CPU %.2e, hist "
            "moves %d" % (tag, L_c, blk, errs[-1], moves))
    return dict(err=max(errs))


# ---------------------------------------------------------------------------
# phase E: device prep, full-length and multiplexed banks
# ---------------------------------------------------------------------------

RAW_SR = 100.0                                      # raw rate of E1, E3
DEC = 2
FILT = [1.0, 10.0, 2, True]


def raw_chunks(rng, B, L_raw, events):
    """B raw three-channel chunks [B, 3, L_raw] float32 of noise, an offset
    and a trend, with an 8 s band-limited event (independent per channel,
    ~8x the noise) at each raw sample ``p`` of (chunk, p) ``events``."""
    X = rng.standard_normal((B, NC, L_raw)) + 3.0
    X += np.linspace(0.0, 20.0, L_raw)[None, None, :]
    for b, p in events:
        w = np.stack([np.convolve(rng.standard_normal(800), np.hanning(10),
                                  "same") for _ in range(NC)])
        w *= np.hanning(800) / w.std()
        X[b, :, p:p + 800] += 8.0 * w
    return X.astype(np.float32)


def oracle_templates(X, lens, events, H, nfftp, n):
    """One unit template of n multiplexed samples per (chunk, raw sample)
    event, cut from the float64 oracle's prepped chunk (prep.prep_numpy)
    4 s before the event, and the prepped chunks by chunk index."""
    Hn = H.cpu().numpy()
    prepped, Us = {}, []
    for b, p in events:
        if b not in prepped:
            prepped[b] = tprep.prep_numpy(X[b], lens[b], Hn, nfftp, DEC, NC)
        off = NC * (p // DEC - int(4 * RAW_SR / DEC))
        u = prepped[b][off:off + n]
        need(len(u) == n, "event at raw sample %d too late for a template"
             % p)
        Us.append((u / np.linalg.norm(u))[None, :])
    return Us, prepped


def check_triggers(tag, planted, oracle, maxds, tidx, tval, tcnt, S_real):
    """Every planted (chunk, detector) triggers once at the float64
    oracle's argmax with its DS (and the row maximum) within 2e-5; no
    other row triggers (rows from S_real on are padding). ``oracle(b, s)``
    is the oracle's DS row. Returns the largest DS error."""
    errs = []
    for b, s in planted:
        ds64 = oracle(b, s)
        i64 = int(np.nanargmax(ds64))
        need(tcnt[b, s] == 1 and int(tidx[b, s, 0]) == i64,
             "phase %s (%d, %d): %d triggers, first at %d, oracle argmax %d"
             % (tag, b, s, tcnt[b, s], tidx[b, s, 0], i64))
        errs += [abs(float(tval[b, s, 0]) - float(ds64[i64])),
                 abs(float(maxds[b, s]) - float(np.nanmax(ds64)))]
        need(max(errs[-2:]) <= 2e-5, "phase %s (%d, %d) DS err %g"
             % (tag, b, s, max(errs[-2:])))
    extra = [(b, s) for b in range(tcnt.shape[0]) for s in range(S_real)
             if tcnt[b, s] and (b, s) not in set(planted)]
    need(not extra and not tcnt[:, S_real:].any(),
         "phase %s rows without a planted event triggered: %s"
         % (tag, extra[:8]))
    return max(errs)


def timed_runs(fn, n=3):
    """(last result, host seconds of runs 2..n): the first run warms up."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times[1:]


def phase_e1_setup(dev, tmpdir, S=128, B=8, seconds=3720.0, seed=41):
    """E1: an artifact of S detectors of 30 s single-basis templates at
    50 Hz (n_c 1500) with filt [1, 10, 2, true] and decimate 2, raw
    [B, 3, seconds * 100] chunks at 100 Hz with four events; the planted
    detectors' templates come from the oracle's prepped chunks."""
    rng = np.random.default_rng(seed)
    sr = RAW_SR / DEC
    n = int(30 * sr * NC)
    L_raw = int(seconds * RAW_SR)
    nfftp = tds.required_fft_len(int(seconds * sr), n // NC)
    H = tprep.butter_response(FILT, RAW_SR, DEC * nfftp, device=dev)
    # (chunk, detector, raw sample of the event)
    planted = [(b % B, s % S, int(f * L_raw)) for b, s, f in (
        (0, 3, 0.11), (2, 77, 0.4), (5, 127, 0.7), (B - 1, 40, 0.9))]
    X = raw_chunks(rng, B, L_raw, [(b, p) for b, _, p in planted])
    Up, prepped = oracle_templates(X, [L_raw] * B,
                                   [(b, p) for b, _, p in planted], H, nfftp,
                                   n)
    Us = [basis(rng, 1, n) for _ in range(S)]
    for (_, s, _), u in zip(planted, Up):
        Us[s] = u
    meta = {"stations": {SERVE_STA: {"nc": NC, "sr": sr, "detectors": [
        dict(name="SG%03d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%03d" % s]) for s in range(S)]}},
        "filt": FILT, "decimate": DEC, "version": 1}
    arrays = {"U__%s__SG%03d" % (SERVE_STA, s): Us[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = os.path.join(tmpdir, "detectors_e1.npz")
    np.savez(path, **arrays)
    dep = serving.load_detectors(path, chunk_sec=seconds - 120, conBuff=120,
                                 device=dev)
    return dict(dep=dep, X=X, Us=Us, prepped=prepped, n=n,
                planted=[(b, s) for b, s, _ in planted])


def phase_e1(su):
    """E1: serving.scan_station_raw on the raw chunks (route
    "fused-net+fusedprep+devicePrep": prep_multiplex_batch, fwd_prep_fold,
    spec_ds_fold)."""
    X, Us, n = su["X"], su["Us"], su["n"]
    B, S = X.shape[0], len(Us)
    bank = su["dep"][SERVE_STA]["banks"][0]
    say("phase E1: %d detectors, raw B=%d x %s at %g Hz, decimate %d, blk %d"
        % (S, B, X.shape[1:], RAW_SR, DEC, bank["blk_fft"]))
    res, times = timed_runs(lambda: serving.scan_station_raw(
        su["dep"], SERVE_STA, X, max_trig=8))
    r = res[0]
    nv = ((X.shape[2] // DEC) * NC - n) // NC + 1
    need(np.array_equal(r["hist"].sum(axis=1), np.full(S, B * nv)),
         "phase E1 histogram totals off")
    err = check_triggers(
        "E1", su["planted"],
        lambda b, s: tds.ds_numpy(su["prepped"][b], Us[s], NC), r["maxds"],
        r["trig_idx"], r["trig_val"], r["trig_count"], S)
    best = min(times)
    say("phase E1: s/request %s (best %.6f), planted DS err vs float64 "
        "oracle %.2e" % ([round(t, 6) for t in times], best, err))
    return dict(s_per_request=best, oracle_err=err)


def phase_e2_setup(dev, B=8, seconds=3720.0, seed=42):
    """E2: 14 detectors (1-3 basis dims) of 30 s at 100 Hz padded to the
    ladders' 16 x 4 by build_bank(prefer_os=False, pad_S, min_dmax): the
    full-length demuxed form by detex_tpu's budget rule (at 3720 s,
    16*4*3*(2^19/2+1) complex spectra <= 2^26); B chunks with four
    events."""
    rng = np.random.default_rng(seed)
    n = int(30 * SR * NC)
    Lc = int(seconds * SR * NC)
    Us = [basis(rng, 1 + s % 3, n) for s in range(14)]
    bank = tds.build_bank(Us, NC, Lc, dev, prefer_os=False,
                          pad_S=tds.pad_rows(14), min_dmax=tds.pad_dims(3))
    need(tds.bank_kind(bank) == "demux"
         and tuple(bank["sum_u"].shape) == (16, 4),
         "phase E2 bank is not the full-length 16 x 4 form")
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, Lc), generator=g, device=dev)
    # (chunk, detector, channel-aligned offset, basis dim)
    planted = [(0, 2, Lc // 24 // 3 * 3, 2), (3, 7, Lc // 6 // 3 * 3, 0),
               (3, 13, Lc // 2 // 3 * 3, 0), (B - 1, 5, Lc // 10 * 3, 1)]
    for b, s, off, d in planted:
        X[b, off:off + n] += 3.0 * np.sqrt(n) * torch.as_tensor(
            Us[s][d].astype(np.float32), device=dev)
    return dict(X=X, bank=bank, Us=Us,
                planted=[(b, s) for b, s, _, _ in planted])


def phase_e2(dev, e2):
    """E2: scan_chunks with triggers on (route "plain": ds_bank_demux with
    ds_finalize, hist_uniform, the 512-block pyramid), then run_bank,
    run_bank_rows and run_bank_batch over the same chunks."""
    X, bank, Us = e2["X"], e2["bank"], e2["Us"]
    B, Lc = X.shape
    th = np.full(16, 0.5, np.float32)
    say("phase E2: 16 x 4 full-length bank (nfft2 %d), B=%d chunks x %d"
        % (bank["nfft2"], B, Lc))
    out, times = timed_runs(lambda: tscan.scan_chunks(
        X, bank, th, NC, int(20 * SR), max_trig=8))
    hist, maxds, tidx, tval, tcnt = (t.cpu().numpy() for t in out)
    nv = Lc // NC - bank["n_c"] + 1
    need(np.array_equal(hist.sum(axis=1), np.full(16, B * nv)),
         "phase E2 histogram totals off")
    xs = [X[b].cpu().numpy() for b in range(B)]

    def oracle(b, s):
        return tds.ds_numpy(xs[b].astype(np.float64), Us[s], NC)

    err = check_triggers("E2", e2["planted"], oracle, maxds, tidx, tval,
                         tcnt, 14)
    best = min(times)
    rate = B * 3720.0 / 86400.0 / best
    (b0, s0), (b1, s1) = e2["planted"][:2]
    t0 = time.perf_counter()
    full = tds.run_bank(xs[b0], bank, NC)
    t_bank = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = tds.run_bank_rows(xs[b1], bank, NC, [s0, s1])
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = tds.run_bank_batch(xs, bank, NC)
    t_batch = time.perf_counter() - t0
    need(full.shape == (16, nv) and np.array_equal(full, batch[b0]),
         "phase E2 run_bank differs from run_bank_batch")
    for s in (s0, s1):
        need(np.array_equal(rows[s], batch[b1][s]),
             "phase E2 run_bank_rows row %d differs" % s)
    for b, s in e2["planted"]:
        e = float(np.abs(batch[b][s] - oracle(b, s)).max())
        need(e <= 2e-5, "phase E2 run_bank_batch (%d, %d) err %g" % (b, s, e))
        err = max(err, e)
    say("phase E2: s/launch %s (best %.6f), station-days/s %.3f; run_bank "
        "%.6f s, run_bank_rows (2 rows) %.6f s, run_bank_batch (%d chunks) "
        "%.6f s (host clock); planted DS err vs float64 oracle %.2e"
        % ([round(t, 6) for t in times], best, rate, t_bank, t_rows, B,
           t_batch, err))
    return dict(s_per_launch=best, station_days_per_s=rate, oracle_err=err)


def phase_e3_setup(dev, B=8, seconds=3720.0, seed=43):
    """E3: E2's bank shape at 50 Hz (16 x 4 of 30 s, n_c 1500, decimate 2,
    prefer_os=False: full length), raw [B, 3, seconds * 100] chunks at
    100 Hz, chunk 5 ragged (its last 19% zero); the three planted
    detectors' templates cut from the oracle's prepped chunks."""
    rng = np.random.default_rng(seed)
    sr = RAW_SR / DEC
    n = int(30 * sr * NC)
    L_raw = int(seconds * RAW_SR)
    nfftp = tds.required_fft_len(L_raw // DEC, n // NC)
    H = tprep.butter_response(FILT, RAW_SR, DEC * nfftp, device=dev)
    planted = [(1, 0, int(0.13 * L_raw)), (5, 6, int(0.67 * L_raw)),
               (6, 11, int(0.89 * L_raw))]
    X = raw_chunks(rng, B, L_raw, [(b, p) for b, _, p in planted])
    lens = [L_raw] * B
    lens[5] = int(0.81 * L_raw)
    X[5, :, lens[5]:] = 0.0
    Up, prepped = oracle_templates(X, lens, [(b, p) for b, _, p in planted],
                                   H, nfftp, n)
    Us = [basis(rng, 2 + s % 2, n) for s in range(14)]
    for (_, s, _), u in zip(planted, Up):
        Us[s] = u
    bank = tds.build_bank(Us, NC, (L_raw // DEC) * NC, dev, prefer_os=False,
                          pad_S=16, min_dmax=4)
    need(tds.bank_kind(bank) == "demux" and bank["nfft2"] == nfftp,
         "phase E3 bank is not the full-length form")
    return dict(X=X, lens=lens, H=H, bank=bank, Us=Us, prepped=prepped,
                planted=[(b, s) for b, s, _ in planted])


def phase_e3(dev, e3):
    """E3: scan_chunks_raw (route "raw-demux+devicePrep":
    ds_bank_demux_raw with ds_finalize per chunk), then run_bank_raw on
    the ragged planted chunk."""
    X, lens, H, bank, Us = e3["X"], e3["lens"], e3["H"], e3["bank"], e3["Us"]
    B = X.shape[0]
    th = np.full(16, 0.5, np.float32)
    sr = RAW_SR / DEC
    say("phase E3: 16 x 4 full-length bank at %g Hz (nfft2 %d), raw B=%d x "
        "%s, decimate %d, chunk 5 ragged at %d raw samples"
        % (sr, bank["nfft2"], B, X.shape[1:], DEC, lens[5]))
    out, times = timed_runs(lambda: tscan.scan_chunks_raw(
        X, lens, H, bank, th, NC, int(20 * sr), max_trig=8, dec=DEC))
    hist, maxds, tidx, tval, tcnt = (t.cpu().numpy() for t in out)
    n_c = bank["n_c"]
    need(np.array_equal(hist.sum(axis=1), np.full(16, sum(
        v // DEC - n_c + 1 for v in lens))), "phase E3 histogram totals off")

    def oracle(b, s):
        return tds.ds_numpy(e3["prepped"][b][:lens[b] // DEC * NC], Us[s], NC)

    err = check_triggers("E3", e3["planted"], oracle, maxds, tidx, tval,
                         tcnt, 14)
    best = min(times)
    rate = B * 3720.0 / 86400.0 / best
    b, s = e3["planted"][1]
    t0 = time.perf_counter()
    one = tprep.run_bank_raw(X[b, :, :lens[b]], bank, NC, H, DEC)
    t_raw = time.perf_counter() - t0
    e = float(np.abs(one[s] - oracle(b, s)).max())
    need(e <= 2e-5, "phase E3 run_bank_raw err %g" % e)
    say("phase E3: s/launch %s (best %.6f), station-days/s %.3f; run_bank_raw "
        "(ragged chunk) %.6f s (host clock); planted DS err vs float64 "
        "oracle %.2e" % ([round(t, 6) for t in times], best, rate, t_raw,
                         max(err, e)))
    return dict(s_per_launch=best, station_days_per_s=rate,
                oracle_err=max(err, e))


def phase_e4(dev, seed=44):
    """E4, small, each on the card and on the CPU twins with the same
    inputs: a multiplexed bank (template length 1681, not a multiple of 3)
    through run_bank and scan_chunks (route "plain"), the raw path at
    decimate 2 with the complex (one-pass) filter response through
    run_bank_raw and scan_chunks_raw on a full-length bank, and
    scan_chunks_raw on a full-length bank of 129 templates (route
    "raw-demux+devicePrep" in two template blocks)."""
    rng = np.random.default_rng(seed)
    L_c = 40000
    Um = [basis(rng, 2, 1681) for _ in range(3)]
    X = rng.standard_normal((3, NC * L_c)).astype(np.float32)
    X[1, NC * 9000:NC * 9000 + 1681] += 3.0 * np.sqrt(1681) * Um[0][0]
    Ur = [basis(rng, 2, NC * 500) for _ in range(3)]
    # past one template block (TEMPLATE_BLOCK = 128): the raw-demux route
    # in blocks of 128
    Ub = [basis(rng, 1, NC * 500) for _ in range(129)]
    L_raw = DEC * L_c
    Xr = raw_chunks(rng, 2, L_raw, [(0, 30000)])
    lens = [L_raw, L_raw - 7000]
    Xr[1, :, lens[1]:] = 0.0
    filt = FILT[:3] + [False]
    outs = {}
    for d in (dev, "cpu"):
        mux = tds.build_bank(Um, NC, NC * L_c, d)
        need(tds.bank_kind(mux) == "mux", "phase E4 bank is not multiplexed")
        full = tds.build_bank(Ur, NC, NC * L_c, d, prefer_os=False)
        H = tprep.butter_response(filt, RAW_SR, DEC * full["nfft2"], False,
                                  device=d)
        th = np.full(3, 0.6, np.float32)
        outs[str(d)] = (
            [tds.run_bank(X[1], mux, NC)]
            + [t.cpu() for t in tscan.scan_chunks(X, mux, th, NC,
                                                  int(20 * SR), max_trig=8)]
            + [tprep.run_bank_raw(Xr[1, :, :lens[1]], full, NC, H, DEC)]
            + [t.cpu() for t in tscan.scan_chunks_raw(
                Xr, lens, H, full, np.full(3, 0.5, np.float32), NC,
                int(20 * SR / DEC), max_trig=8, dec=DEC)])
        wide = tds.build_bank(Ub, NC, NC * L_c, d, prefer_os=False)
        need(tds.bank_kind(wide) == "demux"
             and wide["nfft2"] == full["nfft2"],
             "phase E4 129-template bank is not the full-length form")
        outs[str(d)] += [t.cpu() for t in tscan.scan_chunks_raw(
            Xr, lens, H, wide, np.full(129, 0.5, np.float32), NC,
            int(20 * SR / DEC), max_trig=8, dec=DEC)]
    g, c = outs[str(dev)], outs["cpu"]
    errs = [float(np.abs(g[0] - c[0]).max()), float(np.abs(g[6] - c[6]).max())]
    for i in (1, 7, 12):               # hist, maxds, idx, val, count
        need(torch.equal(g[i].sum(1), c[i].sum(1)),
             "phase E4 histogram totals differ from the CPU's")
        moves = int((g[i] - c[i]).abs().sum().item())
        need(moves <= max(int(c[i].sum().item()) // 200000, 2),
             "phase E4 histogram moves %d" % moves)
        errs.append((g[i + 1] - c[i + 1]).abs().max().item())
        need(torch.equal(g[i + 2], c[i + 2]) and torch.equal(g[i + 4],
                                                             c[i + 4]),
             "phase E4 triggers differ from the CPU's")
    need(max(errs) <= 2e-5, "phase E4 DS err vs CPU %g" % max(errs))
    ds64 = tds.ds_numpy(X[1].astype(np.float64), Um[0], NC)
    need(int(g[5][1, 0]) == 1 and int(g[3][1, 0, 0]) ==
         int(np.nanargmax(ds64)), "phase E4 multiplexed planted trigger")
    need(g[13].shape == (2, 129), "phase E4 129-template maxds shape %s"
         % (tuple(g[13].shape),))
    say("phase E4: multiplexed bank, the complex-H raw path at decimate %d "
        "and the raw-demux route at S = 129: max err vs CPU %.2e (run_bank, "
        "run_bank_raw, maxds)" % (DEC, max(errs)))
    return dict(err=max(errs))


# ---------------------------------------------------------------------------
# phase F: the detection engine (detect.detex) on the card
# ---------------------------------------------------------------------------

F_SEC = 3720.0                  # conDatDuration 3600 s + conBuff 120 s
F_T0 = 1.5e9                    # start of chunk 0 (POSIX seconds)


def f_chunk(seed, b, L, planted):
    """Raw chunk b [NC, L] of a phase-F station: unit noise from (seed, b)
    plus each planted (signal [NC, k], sample) of the chunk."""
    x = np.random.default_rng((seed, b)).standard_normal((NC, L))
    for sig, at in planted.get(b, ()):
        x[:, at:at + sig.shape[1]] += sig
    return x


def f_stream(x, b, sr):
    """Chunk b as the engine reads it: a port Stream of NC traces starting
    at F_T0 + b * F_SEC."""
    return Stream([Trace(x[c].copy(), dict(
        network="XX", station="F", channel="BH" + "ENZ"[c],
        sampling_rate=sr, starttime=F_T0 + b * F_SEC)) for c in range(NC)])


def f_station(sta, dets, sr, L, n_chunks, seed, planted, chunk_sr=None):
    """The engine's plain inputs of one station: {sta: {channels, sr,
    detectors}} and chunks(sta) over n_chunks fresh chunks (sampled at
    ``chunk_sr``, default ``sr``)."""
    def chunks(name):
        for b in range(n_chunks):
            yield (f_stream(f_chunk(seed, b, L, planted), b, chunk_sr or sr),
                   None, None)
    return {sta: dict(channels=["BHE", "BHN", "BHZ"], sr=sr,
                      detectors=dets)}, chunks


def f_made(chunks, sta):
    """chunks(sta) with its Streams made up front, for one engine run: a
    timed run then reads its chunks ready, as from data on hand, and the
    rate leaves out making them."""
    made = list(chunks(sta))
    return lambda name: iter(made)


def f_detectors(rng, prefix, count, D, n, issubspace):
    """``count`` detectors of white orthonormal bases [D, n] (D = 1: single
    templates) with the fields the engine reads; threshold 0.3."""
    dets = []
    for s in range(count):
        U = basis(rng, D, n)
        if issubspace:
            WFs = 20.0 * rng.standard_normal((3, D)) @ U
            extra = dict(mags=list(rng.uniform(0.5, 2.0, 3)),
                         events=["e0", "e1", "e2"], offsets=[0.0, 0.35, 0.7])
        else:
            WFs = 20.0 * U
            extra = dict(mags=[1.1], events=["e0"], offsets=[0.0])
        dets.append(dict(name="%s%03d" % (prefix, s), U=U, WFs=WFs,
                         threshold=0.3, **extra))
    return dets


def f_plant(dets, events, n):
    """{chunk: [(signal, channel sample)]} of events (chunk, detector,
    channel sample): the detector's first basis row demuxed at amplitude
    sqrt(1.5 n) (DS ~ 0.6 in unit noise)."""
    planted = {}
    for b, s, at in events:
        sig = np.sqrt(1.5 * n) * dets[s]["U"][0].reshape(-1, NC).T
        planted.setdefault(b, []).append((sig, at))
    return planted


def f_rows(db, table):
    """The engine's rows of ``table`` with each row's chunk index."""
    rows = util.loadSQLite(db, table) or []
    for r in rows:
        r["chunk"] = int((r["STMP"] - F_T0) // F_SEC)
    return rows


def f_check(tag, rows, dets, events, seed, L, sr, planted, n_chunks, hist,
            filt=None, dec=None):
    """Every row against the float64 oracle: the rows come in (chunk,
    detector) order, only from planted (chunk, detector) pairs, and each
    pair's STMPs are exactly those of ds_numpy + extract_triggers_np on
    the chunk prepped as the engine preps it (_applyFilter, multiplex),
    DS within 2e-5; every detector's histogram total is the chunks' valid
    DS length. Returns the largest DS error."""
    by = {d["name"]: d for d in dets}
    keys = [(r["chunk"], str(r["Name"])) for r in rows]
    need(keys == sorted(keys), "phase %s rows out of (chunk, detector) "
         "order" % tag)
    want = {(b, dets[s]["name"]) for b, s, _ in events}
    need(set(keys) == want, "phase %s rows at %s, planted %s"
         % (tag, sorted(set(keys) - want), sorted(want - set(keys))))
    errs = []
    for b, name in sorted(want):
        st = construct._applyFilter(f_stream(f_chunk(seed, b, L, planted), b,
                                             sr), filt, dec, "single")
        x64 = construct.multiplex(st, NC).astype(np.float64)
        srd = st[0].stats.sampling_rate
        ds64 = tds.ds_numpy(x64, by[name]["U"], NC)
        idx = ttrig.extract_triggers_np(ds64, by[name]["threshold"],
                                        int(20 * srd), 4096)
        got = [r for r in rows if (r["chunk"], str(r["Name"])) == (b, name)]
        tstamp = st[0].stats.starttime.timestamp
        need([r["STMP"] for r in got] == [i / srd + tstamp for i in idx],
             "phase %s (%d, %s) STMP %s, oracle %s" % (
                 tag, b, name, [r["STMP"] for r in got],
                 [i / srd + tstamp for i in idx]))
        errs += [abs(r["DS"] - ds64[i]) for r, i in zip(got, idx)]
        need(all(np.isfinite(r["SNR"]) for r in got),
             "phase %s (%d, %s) SNR not finite" % (tag, b, name))
    need(max(errs) <= 2e-5, "phase %s DS err %g" % (tag, max(errs)))
    L_d = L // (dec or 1)
    for name, h in hist.items():
        n_c = by[name]["U"].shape[1] // NC
        need(h.sum() == n_chunks * (L_d - n_c + 1), "phase %s histogram "
             "total of %s %d != %d" % (tag, name, h.sum(),
                                       n_chunks * (L_d - n_c + 1)))
    return max(errs)


def f1_setup(n_chunks=24, seed=61):
    """F1's two stations: the detectors (8 subspace detectors of 30 s,
    D = 4; 8 single templates), the planted events and, per station kind
    "ss" / "sg", (stations, chunks made up front, planted, chunk seed)."""
    rng = np.random.default_rng(seed)
    L = int(F_SEC * SR)
    n = int(30 * SR * NC)
    dets = {"ss": f_detectors(rng, "ss", 8, 4, n, True),
            "sg": f_detectors(rng, "sg", 8, 1, n, False)}
    events = {"ss": [(2, 0, 40000), (5, 1, 200000), (9, 3, 3000),
                     (13, 4, 360000), (18, 6, 123456), (23, 7, 250000)],
              "sg": [(1, 0, 50000), (4, 2, 300000), (10, 3, 7000),
                     (15, 5, 200000), (19, 6, 99999), (22, 7, 333333)]}
    events = {k: [(b % n_chunks, s, at) for b, s, at in v]
              for k, v in events.items()}
    inputs = {}
    for i, k in enumerate(("ss", "sg")):
        planted = f_plant(dets[k], events[k], n)
        stations, chunks = f_station("XX.F1" + k, dets[k], SR, L, n_chunks,
                                     10 * seed + i, planted)
        inputs[k] = (stations, f_made(chunks, "XX.F1" + k), planted,
                     10 * seed + i)
    return dets, events, inputs


def f1_run(dev, db, inputs):
    """Both F1 stations through detect.detex (batchSize 8) into ``db``:
    (histograms per kind, wall seconds of the two engine runs)."""
    hists = {}
    wall = 0.0
    for k, issub in (("ss", True), ("sg", False)):
        stations, chunks = inputs[k][:2]
        t0 = time.perf_counter()
        hists[k] = detect.detex(stations, chunks, db, issubspace=issub,
                                batchSize=8, device=dev)["XX.F1" + k]
        wall += time.perf_counter() - t0
    return hists, wall


def phase_f1(dev, tmpdir, n_chunks=24, seed=61):
    """F1: one station-day (24 chunks of 3720 s at 100 Hz, 3 channels) of a
    station of 8 subspace detectors (30 s, D = 4) and one of 8 single
    templates, six planted events each, through detect.detex (batchSize 8,
    histograms, magnitudes, trigCon 0, STA/LTA 5 s) into one SQLite
    database; every row against the float64 oracle."""
    L = int(F_SEC * SR)
    dets, events, inputs = f1_setup(n_chunks, seed)
    db = os.path.join(tmpdir, "f1.db")
    hists, wall = f1_run(dev, db, inputs)
    inputs = {k: v[2:] for k, v in inputs.items()}
    errs = []
    for k, table in (("ss", "ss_df"), ("sg", "sg_df")):
        planted, sd = inputs[k]
        errs.append(f_check("F1 " + k, f_rows(db, table), dets[k], events[k],
                            sd, L, SR, planted, n_chunks, hists[k]))
    rate = 2 * n_chunks * 3600.0 / 86400.0 / wall
    say("phase F1: 2 stations x %d chunks (8 subspace detectors D=4, 8 "
        "single templates, 30 s), %.3f s end to end on chunks made before "
        "the clock (host filter, banks, scan, re-verify, magnitudes, "
        "SQLite): %.3f station-days/s (%s); "
        "planted DS err vs float64 oracle %.2e"
        % (n_chunks, wall, rate, card_line(), max(errs)))
    return dict(wall_s=wall, station_days_per_s=rate, oracle_err=max(errs))


def phase_f2(dev, tmpdir, n_chunks=8, seed=62, n_det=1000):
    """F2: the bench.py network station, 1000 single templates of 30 s
    (pad_rows: 1024 rows, 8 template blocks) over 8 chunks of 3720 s with
    four planted events in distinct templates, through detect.detex: the
    blocked route, rows against the float64 oracle. Returns what the
    bitwise check against the per-block scans needs."""
    rng = np.random.default_rng(seed)
    L = int(F_SEC * SR)
    n = int(30 * SR * NC)
    dets = f_detectors(rng, "nw", n_det, 1, n, False)
    events = [(b % n_chunks, s % n_det, at) for b, s, at in (
        (0, 3, 40000), (2, 517, 200000), (5, 768, 9000), (7, 999, 300000))]
    planted = f_plant(dets, events, n)
    stations, chunks = f_station("XX.F2", dets, SR, L, n_chunks, seed,
                                 planted)
    db = os.path.join(tmpdir, "f2.db")
    chunks = f_made(chunks, "XX.F2")
    t0 = time.perf_counter()
    hist = detect.detex(stations, chunks, db, issubspace=False, batchSize=8,
                        device=dev)["XX.F2"]
    wall = time.perf_counter() - t0
    need(tscan.ROUTE_COUNTS.get("blocked-fused-net+fusedprep", 0) == 1,
         "phase F2 routes %s" % dict(tscan.ROUTE_COUNTS))
    err = f_check("F2", f_rows(db, "sg_df"), dets, events, seed, L, SR,
                  planted, n_chunks, hist)
    say("phase F2: %d single templates (%d rows, %d blocks) x %d chunks, "
        "%.3f s end to end; planted DS err vs float64 oracle %.2e"
        % (n_det, tds.pad_rows(n_det), -(-tds.pad_rows(n_det) //
                                         tscan.TEMPLATE_BLOCK),
           n_chunks, wall, err))
    return dict(dets=dets, planted=planted, L=L, seed=seed, hist=hist,
                n_chunks=n_chunks, wall_s=wall, oracle_err=err)


def phase_f2_blocks(dev, f2):
    """F2's summary scan, bit for bit: the engine's bank (build_bank with
    pad_rows / pad_dims) over the engine's prepped chunks, scanned
    summary-only through the blocked route and as its eight blocks of 128
    templates (slices of its arrays) through the unblocked route: equal
    histograms and maxima, and equal to the engine's histograms."""
    dets = f2["dets"]
    X = np.stack([construct.multiplex(construct._applyFilter(
        f_stream(f_chunk(f2["seed"], b, f2["L"], f2["planted"]), b, SR),
        None, None, "single"), NC) for b in range(f2["n_chunks"])])
    bank = tds.build_bank([d["U"] for d in dets], NC, X.shape[1], dev,
                          pad_S=tds.pad_rows(len(dets)),
                          min_dmax=tds.pad_dims(1))
    Sp = int(bank["sum_u"].shape[0])
    th = np.full(Sp, np.inf, np.float32)
    th[:len(dets)] = 0.3
    kw = dict(buff_samps=1, max_trig=1, calc_triggers=False)
    tscan.ROUTE_COUNTS.clear()
    hist, maxds = tscan.scan_chunks(X, bank, th, NC, **kw)[:2]
    parts = []
    for i in range(0, Sp, tscan.TEMPLATE_BLOCK):
        sub = {k: v for k, v in bank.items() if not k.startswith("_")}
        for k in ("Ufd2", "sum_u", "d_mask"):
            sub[k] = bank[k][i:i + tscan.TEMPLATE_BLOCK]
        parts.append(tscan.scan_chunks(X, sub, th[i:i + tscan.TEMPLATE_BLOCK],
                                       NC, **kw)[:2])
    need(dict(tscan.ROUTE_COUNTS) == {"blocked-fused-net+fusedprep": 1,
                                      "fused-net+fusedprep": len(parts)},
         "phase F2 check routes %s" % dict(tscan.ROUTE_COUNTS))
    same_h = torch.equal(hist, torch.cat([p[0] for p in parts]))
    same_m = torch.equal(maxds, torch.cat([p[1] for p in parts], dim=1))
    need(same_h and same_m, "phase F2 blocked scan differs from the "
         "per-block scans (hist %s, maxds %s)" % (same_h, same_m))
    h = hist.cpu().numpy()
    need(all(np.array_equal(f2["hist"][d["name"]], h[s])
             for s, d in enumerate(dets)),
         "phase F2 engine histograms differ from the blocked scan's")
    say("phase F2: blocked summary scan of %d rows equals the %d per-block "
        "scans bit for bit (hist, maxds) and the engine's histograms"
        % (Sp, len(parts)))
    return dict(bitwise=True)


def f3_inputs(rng, n_chunks, seed):
    """F3's station at 50 Hz (decimate 2 of 100 Hz raw chunks): 8 subspace
    detectors of 30 s (D = 4), each basis from the prepped data (filt
    [1, 10, 2, true], decimate 2): detectors 0-5 lead with the window of a
    planted 8 s band-limited event (six events, one a chunk), the rest of
    the rows from stretches of a quiet chunk that is not scanned."""
    L = int(F_SEC * RAW_SR)
    sr = RAW_SR / DEC
    n = int(30 * sr * NC)
    chunks_of = sorted({b % n_chunks for b in (3, 6, 10, 14, 17, 21)})
    planted = {}
    for b in chunks_of:
        w = np.stack([np.convolve(rng.standard_normal(800), np.hanning(10),
                                  "same") for _ in range(NC)])
        planted[b] = [(8.0 * w * np.hanning(800) / w.std(),
                       int(rng.integers(20000, L - 20000)))]

    def prepped(b):
        st = construct._applyFilter(f_stream(f_chunk(seed, b, L, planted), b,
                                             RAW_SR), FILT, DEC, "single")
        return construct.multiplex(st, NC).astype(np.float64)

    quiet = prepped(n_chunks)
    dets = []
    for s in range(8):
        rows = []
        if s < len(chunks_of):
            b = chunks_of[s]
            at = planted[b][0][1] // DEC - int(6 * sr)
            rows.append(prepped(b)[at * NC:at * NC + n])
        while len(rows) < 4:
            at = int(rng.integers(0, len(quiet) // NC - n // NC))
            rows.append(quiet[at * NC:at * NC + n])
        q, _ = np.linalg.qr(np.stack(rows).T)
        U = np.ascontiguousarray(q.T)
        dets.append(dict(name="dp%03d" % s, U=U, WFs=np.stack(rows[:3]),
                         mags=[1.0, 1.3, 0.8], events=["e0", "e1", "e2"],
                         offsets=[0.0, 0.4, 0.8], threshold=0.3))
    return dets, planted, L


def phase_f3(dev, tmpdir, n_chunks=24, seed=63):
    """F3: F1's subspace station shape (8 detectors of 30 s, D = 4) at 50
    Hz on raw 100 Hz chunks with filt [1, 10, 2, true] and decimate 2:
    detect.detex with devicePrep (the device prep, route
    "fused-net+fusedprep+devicePrep", triggered chunks re-filtered on the
    host). Returns the inputs of the host-filter run it is held
    against."""
    dets, planted, L = f3_inputs(np.random.default_rng(seed), n_chunks, seed)
    stations, raw_chunks = f_station("XX.F3", dets, RAW_SR / DEC, L,
                                     n_chunks, seed, planted, RAW_SR)
    db = os.path.join(tmpdir, "f3_dev.db")
    chunks = f_made(raw_chunks, "XX.F3")
    t0 = time.perf_counter()
    detect.detex(stations, chunks, db, filt=FILT, decimate=DEC,
                 devicePrep=True, batchSize=8, estimateMags=False, device=dev)
    wall = time.perf_counter() - t0
    need(tscan.ROUTE_COUNTS.get("fused-net+fusedprep+devicePrep", 0) > 0,
         "phase F3 routes %s" % dict(tscan.ROUTE_COUNTS))
    return dict(stations=stations, chunks=raw_chunks, db=db, wall_s=wall,
                n_events=len(planted))


def phase_f3_host(dev, tmpdir, f3):
    """F3's rows against the same engine with the host filter (devicePrep
    off) on the same raw chunks, as detex_tpu's
    test_deviceprep_matches_host_detections holds them: the same rows,
    STMP within 0.2 s, DS within 1e-3; one row for each planted event."""
    db = os.path.join(tmpdir, "f3_host.db")
    chunks = f_made(f3["chunks"], "XX.F3")
    t0 = time.perf_counter()
    detect.detex(f3["stations"], chunks, db, filt=FILT, decimate=DEC,
                 batchSize=8, estimateMags=False, device=dev)
    wall = time.perf_counter() - t0
    dev_rows = util.loadSQLite(f3["db"], "ss_df") or []
    host_rows = util.loadSQLite(db, "ss_df") or []
    need(len(host_rows) == f3["n_events"], "phase F3 host path found %d "
         "rows for %d events" % (len(host_rows), f3["n_events"]))
    need(len(dev_rows) == len(host_rows), "phase F3 devicePrep rows %d, "
         "host rows %d" % (len(dev_rows), len(host_rows)))
    need([r["Name"] for r in dev_rows] == [r["Name"] for r in host_rows],
         "phase F3 row names differ")
    dt = max(abs(a["STMP"] - b["STMP"]) for a, b in zip(dev_rows, host_rows))
    dds = max(abs(a["DS"] - b["DS"]) for a, b in zip(dev_rows, host_rows))
    need(dt < 0.2 and dds < 1e-3, "phase F3 STMP diff %g, DS diff %g"
         % (dt, dds))
    say("phase F3: devicePrep %d rows = host-filter rows (STMP diff %.3g s, "
        "DS diff %.3g); %.3f s end to end with devicePrep, %.3f s with the "
        "host filter" % (len(dev_rows), dt, dds, f3["wall_s"], wall))
    return dict(rows=len(dev_rows), stmp_diff=dt, ds_diff=dds,
                wall_dev_s=f3["wall_s"], wall_host_s=wall)


# ---------------------------------------------------------------------------
# phase G: detector construction on the card (bench.py cluster's geometry)
# ---------------------------------------------------------------------------

G_STATIONS = ("XX.G1", "XX.G2")
G_SOURCES, G_PER_SOURCE, G_SINGLES = 20, 10, 20   # 220 events a station
G_TRIM = (10, 120)                  # seconds before / after the origin
G_WAVE = 3000                       # 30 s event waveform (channel samples)
G_FILT = [1, 10, 2, True]           # createCluster's default filter
G_T0 = 1.6e9                        # origin of event 0 (POSIX seconds)
# null chunks a station for FAS (detex_tpu's default is 50; cut to keep
# the smoke inside its time: the host's beta fit costs ~0.1 s per chunk
# and detector)
G_CON_DAT_NUM = 20


def g_waveform(rng):
    """A [NC, G_WAVE] band-limited (1-10 Hz at 100 Hz) event waveform with
    tapered ends, unit std. It fills the 30 s detector window, so a
    detector sees a foreign event as it sees filtered noise: the
    thresholds from the noise null then hold for other sources' events
    too (a shorter or enveloped waveform has fewer degrees of freedom than
    the window's noise and can pass a threshold set at Pf 1e-12)."""
    from scipy.signal import butter, sosfiltfilt
    from scipy.signal.windows import tukey
    sos = butter(4, [1.0, 10.0], btype="bandpass", fs=SR, output="sos")
    w = sosfiltfilt(sos, rng.standard_normal((NC, G_WAVE)), axis=1)
    w *= tukey(G_WAVE, 0.1)
    return w / w.std()


def g_catalog(seed=71):
    """Phase G's seeded catalog: 220 events (20 sources of 10 events, then
    20 singles), each with an origin, magnitude and a per-event shift of
    its onset (channel samples, the planted misalignment); per station
    the sources' waveforms (a main and a second component, so subspaces
    need one or two dimensions), the singles' waveforms and the travel
    times of every source and single."""
    rng = np.random.default_rng(seed)
    n_ev = G_SOURCES * G_PER_SOURCE + G_SINGLES
    src = [k // G_PER_SOURCE if k < G_SOURCES * G_PER_SOURCE
           else G_SOURCES + k - G_SOURCES * G_PER_SOURCE
           for k in range(n_ev)]
    order = rng.permutation(n_ev)            # names do not follow sources
    events = [dict(name="ev%03d" % int(order[k]), src=src[k],
                   time=G_T0 + 1000.0 * int(order[k]),
                   mag=float(rng.uniform(0.5, 2.5)),
                   shift=int(rng.integers(-100, 101)),
                   mix=float(rng.uniform(-0.6, 0.6)))
              for k in range(n_ev)]
    waves = {sta: dict(main=[g_waveform(rng) for _ in range(G_SOURCES +
                                                             G_SINGLES)],
                       second=[g_waveform(rng) for _ in range(G_SOURCES)],
                       tt=rng.integers(200, 801, G_SOURCES + G_SINGLES))
             for sta in G_STATIONS}
    return events, waves


def g_signal(waves, sta, src, mix):
    """Source (or single) ``src``'s waveform at ``sta``: the main waveform
    plus ``mix`` times the second component (sources only)."""
    w = waves[sta]["main"][src]
    if src < G_SOURCES:
        w = w + mix * waves[sta]["second"][src]
    return w


def g_templates(events, waves, seed=72):
    """createCluster's inputs: per station {event: Stream} of 130 s (trim
    [10, 120] around the origin: 13,000 samples a channel, 39,000
    multiplexed) of white noise (std 0.05) with the event's waveform at its
    onset (10 s + travel time + shift after the window opens, amplitude
    from the magnitude); the template rows; the picks at each onset."""
    n = int(sum(G_TRIM) * SR)
    streams = {sta: {} for sta in G_STATIONS}
    picks = []
    for si, sta in enumerate(G_STATIONS):
        for e in events:
            rng = np.random.default_rng((seed, si, int(e["name"][2:])))
            x = 0.05 * rng.standard_normal((NC, n))
            on = int(G_TRIM[0] * SR) + int(waves[sta]["tt"][e["src"]]) + \
                e["shift"]
            x[:, on:on + G_WAVE] += 10 ** (0.3 * e["mag"]) * g_signal(
                waves, sta, e["src"], e["mix"])
            t0 = e["time"] - G_TRIM[0]
            streams[sta][e["name"]] = Stream([Trace(x[c], dict(
                network="XX", station=sta[3:], channel="BH" + "ENZ"[c],
                sampling_rate=SR, starttime=t0)) for c in range(NC)])
            picks.append(dict(TimeStamp=t0 + on / SR, Station=sta,
                              Event=e["name"], Phase="P"))
    templates = {e["name"]: {"time": e["time"], "mag": e["mag"]}
                 for e in events}
    return streams, templates, picks


def g_null_chunks(seed=73):
    """FAS's chunks(sta): a fresh iterator on every call over 4 *
    G_CON_DAT_NUM candidate null chunks of 3720 s of unit white noise,
    each made when it is read."""
    L = int(F_SEC * SR)

    def chunks(sta):
        si = G_STATIONS.index(sta)
        for k in range(4 * G_CON_DAT_NUM):
            x = np.random.default_rng((seed, si, k)).standard_normal((NC, L))
            st = Stream([Trace(x[c], dict(
                network="XX", station=sta[3:], channel="BH" + "ENZ"[c],
                sampling_rate=SR, starttime=F_T0 - 1e7 + F_SEC * k))
                for c in range(NC)])
            yield st, None, None
    return chunks


def ccx2_np(x1, x2, nc):
    """float64 numpy oracle of the reference _CCX2 (construct.py:425-466):
    (maxcc, integer lag, the channel-aligned truncated cc curve)."""
    n = len(x1)
    trunc = n // (2 * nc) - 1
    nfft = 2 ** int(2 * n).bit_length()
    x1 = np.asarray(x1, np.float64)
    x2 = np.asarray(x2, np.float64)
    c = np.fft.irfft(np.conj(np.fft.rfft(x1, nfft)) * np.fft.rfft(x2, nfft),
                     nfft)
    c1 = np.concatenate([c[-(n - 1):], c[:n]])
    padded = np.pad(x2, (n - 1, n - 1))
    cs = np.cumsum(np.insert(padded, 0, 0.0))
    cs2 = np.cumsum(np.insert(padded ** 2, 0, 0.0))
    a = (cs[n:] - cs[:-n]) / n
    b = np.sqrt(np.maximum((cs2[n:] - cs2[:-n]) / n - a * a, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = (c1 - x1.sum() * a) / (n * b * x1.std())
    r = r[nc - 1::nc][trunc:-trunc]
    r[(r > 1) | (r < -1)] = 0.0
    k = int(np.nanargmax(r))
    return r[k], (k + 1 + trunc) * nc - n, r


def g_hold_pairs(tag, X, pairs, cc, lag, tol=2e-5):
    """cc of ``pairs`` against ccx2_np within ``tol``, the lag exact where
    the oracle's peak leads its runner-up by more than ``tol``. Returns
    (largest cc error, clear pairs)."""
    err, clear = 0.0, 0
    for i, j in pairs:
        occ, olag, r = ccx2_np(X[i], X[j], NC)
        err = max(err, abs(cc[i, j] - occ))
        top2 = np.sort(r[np.isfinite(r)])[-2:]
        if top2[1] - top2[0] > tol:
            clear += 1
            need(lag[i, j] == olag, "phase %s pair (%d, %d) lag %d, oracle "
                 "%d" % (tag, i, j, lag[i, j], olag))
    need(err <= tol, "phase %s cc err %g vs float64 oracle" % (tag, err))
    return err, clear


def phase_g1(dev, g):
    """G1: bench.py cluster's geometry, 2 stations x 220 events x 39,000
    multiplexed samples (24,090 pairs a station) through
    ops/xcorr.xcorr_all_pairs on the card (polyphase path, nfft2 32768),
    timed after one warm-up call; 256 seeded pairs (192 at random, 64
    within sources) held against the float64 oracle of _CCX2, and a small
    full-path case (8 events cut to 38,999 samples, n % 3 != 0)."""
    X = {sta: np.stack([construct.multiplex(g["streams"][sta][e["name"]],
                                            NC) for e in g["events"]])
         .astype(np.float32) for sta in G_STATIONS}
    N, n = X[G_STATIONS[0]].shape
    xcorr.xcorr_all_pairs(X[G_STATIONS[0]], NC, device=dev)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {sta: xcorr.xcorr_all_pairs(X[sta], NC, device=dev)
           for sta in G_STATIONS}
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(74)
    iu, ju = np.triu_indices(N, 1)
    src = np.array([e["src"] for e in g["events"]])
    same = np.flatnonzero((src[iu] == src[ju]) & (src[iu] < G_SOURCES))
    errs, clear, held = [], 0, 0
    for sta in G_STATIONS:
        pick = np.concatenate([
            rng.choice(len(iu), min(96, len(iu)), replace=False),
            rng.choice(same, min(32, len(same)), replace=False)])
        held += len(pick)
        cc, lag, sub = out[sta]
        need(np.isfinite(cc[iu, ju]).all() and np.isfinite(sub[iu, ju]).all(),
             "phase G1 %s: non-finite cc or subsample" % sta)
        e, c = g_hold_pairs("G1 " + sta, X[sta], zip(iu[pick], ju[pick]),
                            cc, lag)
        errs.append(e)
        clear += c
        need(cc[iu[same], ju[same]].min() > 0.5, "phase G1 %s: a pair of "
             "one source below cc 0.5" % sta)
    need(clear >= 0.75 * held, "phase G1: only %d of %d pairs with a "
         "clear peak" % (clear, held))
    Xf = X[G_STATIONS[0]][:8, :n - 1]
    cc, lag, _ = xcorr.xcorr_all_pairs(Xf, NC, device=dev)
    ef, _ = g_hold_pairs("G1 full path", Xf, zip(*np.triu_indices(8, 1)), cc,
                         lag)
    say("phase G1: xcorr_all_pairs 2 stations x %d events x %d samples "
        "(%d pairs a station, nfft2 %d): %.3f s after one warm-up call (%s); "
        "%d pairs vs float64 oracle: cc err %.2e, %d clear peaks, lags "
        "exact; full path (n %d) cc err %.2e"
        % (N, n, len(iu), xcorr.fft_len_for(n // NC), wall, card_line(),
           held, max(errs), clear, n - 1, ef))
    return dict(wall_s=wall, cc_err=max(errs), full_err=ef)


class FasClock(object):
    """Times every fas._initFAS call (wall seconds, ``wall``) and the
    card's busy time inside it (the union of its kernels' intervals,
    torch.profiler); ``inside`` adds the profiler's own start and
    processing, which the caller's stage clock must leave out."""

    def __init__(self):
        self.wall = 0.0
        self.inside = 0.0
        self.device_us = 0.0
        self.launches = dict.fromkeys(ck.LAUNCHES, 0)
        self.orig = fas._initFAS

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        def timed(*args, **kw):
            t_in = time.perf_counter()
            before = dict(ck.LAUNCHES)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                out = self.orig(*args, **kw)
                torch.cuda.synchronize()
                self.wall += time.perf_counter() - t0
            for k in self.launches:
                self.launches[k] += ck.LAUNCHES[k] - before[k]
            self.inside += time.perf_counter() - t_in
            self.device_us += busy_us([e for e in p.events()
                                     if e.device_type ==
                                     torch.autograd.DeviceType.CUDA])
            return out
        fas._initFAS = timed
        return self

    def __exit__(self, *exc):
        fas._initFAS = self.orig


def busy_us(events):
    """Length of the union of device intervals, in microseconds."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


# the station-day's planted events: (chunk, source, channel sample);
# "single" plants single 0's waveform
G_PLANT = [(1, 0, 50000), (4, 1, 300000), (8, 2, 7000), (11, 0, 200000),
           (15, 1, 99999), (20, 2, 333333), (22, "single", 150000)]


def g_station_day(g, sta, seed, n_chunks=24):
    """SubSpace.detex's chunks for one station-day: 24 chunks of 3720 s of
    unit noise with G_PLANT's events at amplitude 3. The chunks' arrays are
    made before the clock; every call wraps fresh Streams around copies
    (the engine filters its Streams in place). Returns (chunks, planted)."""
    L = int(F_SEC * SR)
    planted = {}
    for b, s, at in G_PLANT:
        src = G_SOURCES if s == "single" else s
        mix = 0.3 if s != "single" else 0.0
        planted.setdefault(b % n_chunks, []).append(
            (3.0 * g_signal(g["waves"], sta, src, mix), at))
    made = [f_chunk(seed, b, L, planted) for b in range(n_chunks)]

    def chunks(name):
        for b, x in enumerate(made):
            yield f_stream(x, b, SR), None, None
    return chunks, planted


def phase_g2(dev, g, tmpdir):
    """G2: detector construction end to end on G1's events, per station:
    createCluster (CCreq 0.5) -> createSubSpace (dtype single) ->
    attachPickTimes (defaultDuration 30) -> SVD(selectCriteria 2,
    selectValue 0.9, conDatNum G_CON_DAT_NUM, useSingles) on null chunks
    of 3720 s -> SubSpace.detex over one station-day with G_PLANT's
    events. Gates: every source one cluster and every single single;
    alignment delays recover the planted shifts to one channel sample;
    thresholds in (0, 1); one detector's beta fit against the fit of the
    float64 oracle DS (ds_numpy) of the same null chunks; the SQLite rows
    against the float64 oracle as phase F holds them."""
    stages = {}
    t0 = time.perf_counter()
    cl = construct.createCluster(streams=g["streams"],
                                 templates=g["templates"], CCreq=0.5,
                                 filt=G_FILT, trim=list(G_TRIM),
                                 saveclust=False, device=dev)
    stages["cluster"] = time.perf_counter() - t0
    by_src = {}
    for e in g["events"]:
        by_src.setdefault(e["src"], []).append(e["name"])
    want_clusts = sorted(sorted(v) for s, v in by_src.items()
                         if s < G_SOURCES)
    want_singles = sorted(v[0] for s, v in by_src.items() if s >= G_SOURCES)
    for sta in G_STATIONS:
        need(sorted(sorted(c) for c in cl[sta].clusts) == want_clusts,
             "phase G2 %s: clusters are not the planted sources" % sta)
        need(cl[sta].singles == want_singles, "phase G2 %s: singles %d, "
             "planted %d" % (sta, len(cl[sta].singles), len(want_singles)))
    t0 = time.perf_counter()
    ss = construct.createSubSpace(clust=cl, Pf=1e-12, dtype="single",
                                  conDatDuration=F_SEC - 120.0, conBuff=120.0)
    ss.attachPickTimes(g["picks"], defaultDuration=30)
    stages["subspace_trims"] = time.perf_counter() - t0
    shift = {e["name"]: e["shift"] for e in g["events"]}
    worst = 0
    for sta in G_STATIONS:
        for row in ss.subspaces[sta]:
            ev = row["Events"]
            d = np.array([round((row["Stats"][e]["starttime"] -
                                 g["templates"][e]["time"] + G_TRIM[0]) * SR)
                          for e in ev])
            s = np.array([shift[e] for e in ev])
            worst = max(worst, int(np.abs((d - d.min()) - (s - s.min()))
                                   .max()))
    need(worst <= 1, "phase G2 alignment delays off the planted shifts by "
         "%d channel samples" % worst)
    nulls = g_null_chunks()
    t0 = time.perf_counter()
    with FasClock() as clock:
        ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=G_CON_DAT_NUM,
               useSingles=True, chunks=nulls)
    svd_total = time.perf_counter() - t0
    stages["svd"] = svd_total - clock.inside
    stages["fas"] = clock.wall
    rows = [r for sta in G_STATIONS
            for r in ss.subspaces[sta] + ss.singles[sta]]
    need(len(rows) == len(G_STATIONS) * (G_SOURCES + G_SINGLES),
         "phase G2: %d detectors" % len(rows))
    ths = np.array([r["Threshold"] for r in rows])
    need(((ths > 0) & (ths < 1)).all(), "phase G2 thresholds outside (0, 1)")
    # one detector's beta fit against the float64 oracle's
    row = ss.subspaces[G_STATIONS[0]][0]
    acc, _, _ = fas._collectChunks(nulls, G_STATIONS[0], G_FILT, None,
                                   "single", G_CON_DAT_NUM, NC, 0.5, 5, 8.0)
    U, _, _ = fas._loadMPSubSpace(row)
    ds64 = np.concatenate([tds.ds_numpy(x.astype(np.float64), U, NC)
                           for x in acc])
    fit64 = fas._fit_null(ds64, row["FAS"]["bins"])["betadist"]
    beta_rel = max(abs(a / b - 1) for a, b in
                   zip(row["FAS"]["betadist"][:2], fit64[:2]))
    need(beta_rel <= 1e-3, "phase G2 beta fit %s vs float64 oracle's %s"
         % (row["FAS"]["betadist"][:2], fit64[:2]))
    # the station-day
    db = os.path.join(tmpdir, "g2.db")
    conts = {sta: g_station_day(g, sta, 75 + k)
             for k, sta in enumerate(G_STATIONS)}
    t0 = time.perf_counter()
    ss.detex(chunks=lambda sta: conts[sta][0](sta), subspaceDB=db,
             useSingles=True, batchSize=8)
    stages["detex"] = time.perf_counter() - t0
    errs = []
    for k, sta in enumerate(G_STATIONS):
        chunks, planted = conts[sta]
        stations = {True: ss._stations(True)[sta],
                    False: ss._stations(False)[sta]}
        for issub, table in ((True, "ss_df"), (False, "sg_df")):
            dets = stations[issub]["detectors"]
            idx = {}
            for di, d in enumerate(dets):
                for e in d["events"]:
                    idx[e] = di
            events = []
            for b, s, at in G_PLANT:
                if (s == "single") == issub:
                    continue
                src = G_SOURCES if s == "single" else s
                events.append((b, idx[by_src[src][0]], at))
            rows_t = [r for r in f_rows(db, table) if r["Sta"] == sta]
            hist = (ss.histSubSpaces if issub else ss.histSingles)[sta]
            errs.append(f_check("G2 %s %s" % (sta, table), rows_t, dets,
                                events, 75 + k, int(F_SEC * SR), SR,
                                planted, 24, hist, filt=G_FILT))
    busy = clock.device_us / 1e6 / clock.wall
    say("phase G2: 2 stations x %d events, %s: stages (s) %s; FAS device "
        "busy %.4f (%.3f of %.3f s); %d subspaces (NumBasis %s) and %d "
        "singles, thresholds %.4f-%.4f; beta fit vs float64 oracle rel "
        "%.2e; planted DS err vs float64 oracle %.2e"
        % (len(g["events"]), card_line(),
           json.dumps({k: round(v, 3) for k, v in
                                     stages.items()}),
           busy, clock.device_us / 1e6, clock.wall,
           sum(len(ss.subspaces[s]) for s in G_STATIONS),
           sorted({r["NumBasis"] for s in G_STATIONS
                   for r in ss.subspaces[s]}),
           sum(len(ss.singles[s]) for s in G_STATIONS), ths.min(), ths.max(),
           beta_rel, max(errs)))
    return dict(stages=stages, fas_busy=busy, beta_rel=beta_rel,
                oracle_err=max(errs), fas_launches=clock.launches)


# ---------------------------------------------------------------------------
# phase H: the Case1 pipeline from key files and indexed directories
# ---------------------------------------------------------------------------

CASE1_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "case1_reference.json")
# H2: the path at full width (100 Hz, 3 channels, hour files of 3720 s),
# two station-days a station; only clustered sources repeat unlisted
H2_PARAMS = {
    "synth": dict(n_sources=4, events_per_source=5, n_singles=2,
                  n_stations=2, sr=100.0, span_hours=48, seed=7,
                  noise=0.04),
    "hidden": dict(n=6, mag=1.4, sources=[0, 1, 2, 3]),
    "directories": dict(tb4=10, taft=120),
    "createCluster": dict(CCreq=0.5, filt=[1, 10, 2, True], trim=[10, 120]),
    "createSubSpace": dict(Pf=1e-9, minEvents=2),
    "attachPickTimes": dict(defaultDuration=30),
    "SVD": dict(selectCriteria=2, selectValue=0.9, conDatNum=12,
                useSingles=True),
    "detex": dict(useSingles=True),
    "detResults": dict(requiredNumStations=2, veriBuffer=4),
}


class Clock(object):
    """Wall seconds spent in calls of the given (module, function name)
    pairs while the context is open, summed per name."""

    def __init__(self, *targets):
        self.targets = targets
        self.seconds = {name: 0.0 for _, name in targets}

    def __enter__(self):
        self.orig = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self.orig):
            def timed(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.orig):
            setattr(mod, name, fn)


def case1_run(params, dtype, workdir, device):
    """The port's Case1 pipeline through its key-file entry points, with
    detex_tpu's calls (scripts/record_case1_reference.py): SynthCatalog
    -> write_directories -> createCluster -> createSubSpace(conDatFetcher
    = DataFetcher("dir")) -> attachPickTimes -> SVD with FAS -> detex ->
    detResults, at ``dtype`` on ``device``. Returns (record, objects,
    stage wall seconds); the record has the fixture's layout."""
    from scipy.cluster.hierarchy import linkage
    from detex_torch import align, results
    from detex_torch.data import fetcher as getdata
    from detex_torch.data.synth import SynthCatalog

    p = params
    stages = {}
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def stage(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        stages[name] = time.perf_counter() - t0
        return out

    cat = SynthCatalog(**p["synth"])
    cat.add_hidden_events(**p["hidden"])
    with Clock((getdata, "indexDirectory")) as idx:
        paths = stage("write", cat.write_directories,
                      os.path.join(workdir, "data"), **p["directories"])
    stages["index"] = idx.seconds["indexDirectory"]
    stages["write"] -= stages["index"]
    clust = stage("cluster", detex_torch.createCluster,
                  fetch_arg=paths["eventDir"],
                  stationKey=paths["stationKey"],
                  templateKey=paths["templateKey"], saveclust=False,
                  fileName=os.path.join(workdir, "clust.pkl"), dtype=dtype,
                  device=device, **p["createCluster"])
    cfetcher = getdata.DataFetcher("dir", directoryName=paths["conDir"])
    ss = stage("subspace", detex_torch.createSubSpace, clust=clust,
               dtype=dtype, conDatFetcher=cfetcher, **p["createSubSpace"])
    rec = {"clusters": {}, "lags": {}, "delays": {}, "detectors": {},
           "rows": {}, "results": {}}
    for cl in clust.clusters:
        rec["clusters"][cl.station] = dict(
            events=list(cl.key), clusts=[sorted(c) for c in cl.clusts],
            singles=list(cl.singles))
        rec["lags"][cl.station] = [[int(x) for x in r]
                                   for r in clust.row(cl.station)["Lags"]]
    for sta, rows in ss.subspaces.items():
        rec["delays"][sta] = {}
        for srow in rows:
            cc, lag = construct._getInfoFromClust(clust, srow)
            link = linkage(construct._flatNoNan(construct.DISSIM_OFFSET -
                                                cc))
            d = align.alignment_delays(link, cc, lag)
            rec["delays"][sta][srow["Name"]] = dict(
                zip(srow["Events"], [int(x) for x in d]))
    stage("picks", ss.attachPickTimes, pksFile=paths["phaseKey"],
          **p["attachPickTimes"])
    with Clock((fas, "_initFAS")) as fc:
        stage("svd", ss.SVD, **p["SVD"])
    stages["fas"] = fc.seconds["_initFAS"]
    stages["svd"] -= stages["fas"]
    for sta in sorted(set(ss.subspaces) | set(ss.singles)):
        rec["detectors"][sta] = [
            dict(kind=kind, Name=r["Name"], Events=list(r["Events"]),
                 NumBasis=int(r["NumBasis"]) if kind == "ss" else None,
                 Threshold=float(r["Threshold"]))
            for kind, frames in (("ss", ss.subspaces), ("sg", ss.singles))
            for r in frames.get(sta, [])]
    db = os.path.join(workdir, "SubSpace.db")
    stage("detex", ss.detex, subspaceDB=db, **p["detex"])
    for table in ("ss_df", "sg_df"):
        rec["rows"][table] = [
            [str(r["Sta"]), str(r["Name"]), float(r["STMP"]),
             float(r["DS"]), float(r["Mag"])]
            for r in util.loadSQLite(db, table) or []]
    res = stage("results", results.detResults, ssDB=db,
                templateKey=paths["templateKey"],
                stationKey=paths["stationKey"], veriFile=paths["veriFile"],
                fetch=cfetcher, **p["detResults"])
    for name in ("Dets", "Autos", "Vers"):
        rec["results"][name] = [
            [str(r["Event"]), float(r["MSTAMPmin"]), float(r["MSTAMPmax"]),
             float(r["DSav"]), int(r["NumStations"])]
            for r in getattr(res, name)]
    rec["hidden"] = [dict(src=int(e["src"]), time=float(e["time"]),
                          mag=float(e["mag"])) for e in cat.hidden]
    return rec, dict(paths=paths, cat=cat, clust=clust, ss=ss, db=db,
                     res=res, cfetcher=cfetcher), stages


def case1_verified(tag, rec):
    """Every hidden event verified, each window bracketing its origin time
    within 10 s (tests/test_pipeline.py::test_detection_times_accurate)."""
    vers = sorted(rec["results"]["Vers"], key=lambda r: r[1])
    hidden = sorted(e["time"] for e in rec["hidden"])
    need(len(vers) == len(hidden), "phase %s: %d verified, %d hidden"
         % (tag, len(vers), len(hidden)))
    for t, r in zip(hidden, vers):
        need(r[1] - 10 <= t <= r[2] + 10, "phase %s: verified window "
             "%.3f-%.3f misses hidden event %.3f" % (tag, r[1], r[2], t))


def case1_hold(tag, got, want, objs):
    """One Case1 run against detex_tpu's record of the same dtype: the
    synthetic catalog's hidden events, clusters, singles, alignment delays
    and NumBasis identical; each lag identical, or where not, a near tie
    of the float64 oracle (its peak leads by at most 1e-5, printed on a
    line of its own; ROADMAP C34); thresholds within 1e-5 relative; every
    ss_df / sg_df row in order with STMP exact and DS within 2e-5; every
    hidden event verified. Returns (threshold rel err, DS err, ties)."""
    need(got["hidden"] == want["hidden"], "phase %s: hidden events differ "
         "from the record" % tag)
    need(got["clusters"] == want["clusters"], "phase %s: clusters %s, "
         "record %s" % (tag, got["clusters"], want["clusters"]))
    ties = 0
    for sta, lag in want["lags"].items():
        row = objs["clust"].row(sta)
        for i, j in zip(*np.nonzero(np.array(got["lags"][sta]) !=
                                    np.array(lag))):
            e1, e2 = row["Events"][i], row["Events"][j]
            _, olag, r = ccx2_np(row["MPtd"][e1], row["MPtd"][e2], NC)
            top2 = np.sort(r[np.isfinite(r)])[-2:]
            lead = top2[1] - top2[0]
            need(lead <= 1e-5, "phase %s %s (%s, %s): lag %d, record %d, "
                 "float64 oracle %d leads by %.3g" % (
                     tag, sta, e1, e2, got["lags"][sta][i][j], lag[i][j],
                     olag, lead))
            ties += 1
            say("phase %s %s (%s, %s): lag %d, record %d: a near tie "
                "(float64 oracle lag %d leads by %.3g <= 1e-5)"
                % (tag, sta, e1, e2, got["lags"][sta][i][j], lag[i][j],
                   olag, lead))
    if not ties:
        need(got["delays"] == want["delays"], "phase %s: alignment delays "
             "%s, record %s" % (tag, got["delays"], want["delays"]))
    th_err = 0.0
    for sta, dets in want["detectors"].items():
        g = got["detectors"][sta]
        need([(d["kind"], d["Name"], d["Events"], d["NumBasis"]) for d in g]
             == [(d["kind"], d["Name"], d["Events"], d["NumBasis"])
                 for d in dets], "phase %s %s: detectors %s, record %s"
             % (tag, sta, g, dets))
        for a, b in zip(g, dets):
            th_err = max(th_err, abs(a["Threshold"] / b["Threshold"] - 1))
    need(th_err <= 1e-5, "phase %s: thresholds off the record by %.3g "
         "relative" % (tag, th_err))
    ds_err = 0.0
    for table, rows in want["rows"].items():
        g = got["rows"][table]
        need([r[:3] for r in g] == [r[:3] for r in rows], "phase %s %s: "
             "rows (Sta, Name, STMP) differ from the record" % (tag, table))
        ds_err = max([ds_err] + [abs(a[3] - b[3]) for a, b in zip(g, rows)])
    need(ds_err <= 2e-5, "phase %s: row DS off the record by %.3g"
         % (tag, ds_err))
    case1_verified(tag, got)
    return th_err, ds_err, ties


class KernelCapture(object):
    """Keeps a copy of the inputs of the first launch of every kernel while
    the context is open (the wrappers of ops/cuda_kernels, which every
    path calls through the module)."""

    def __init__(self):
        self.inputs = {}

    def __enter__(self):
        self.orig = {k: getattr(ck, k) for k in KERNEL_INFO}
        for k, fn in self.orig.items():
            def first(*args, _k=k, _fn=fn, **kw):
                if _k not in self.inputs:
                    self.inputs[_k] = (
                        [a.clone() if torch.is_tensor(a) else a
                         for a in args], dict(kw))
                return _fn(*args, **kw)
            setattr(ck, k, first)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(ck, k, fn)


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def hold_captured(tag, cap):
    """Every captured kernel launched again on its captured inputs and held
    against its twin (the wrapper on copies of the inputs on the CPU, where
    it runs the plain version): spectra atol 2e-3 (a, power: 1e-4, rtol
    1e-4 / atol 1e-3), inverse transforms 2e-5 of the row's largest value,
    DS and block maxima 2e-5 with -inf positions identical, histograms'
    row totals exact with at most one bin move per 2e5 samples."""
    res = {}
    for k, (args, kw) in sorted(cap.inputs.items()):
        fn = getattr(ck, k)
        out_k = [t.cpu() if t is not None else None
                 for t in _tensors(fn(*args, **kw))]
        out_r = _tensors(fn(*[a.cpu() if torch.is_tensor(a) else a
                              for a in args], **kw))
        err = 0.0
        for i, (a, b) in enumerate(zip(out_k, out_r)):
            if a is None or b is None:
                need(a is None and b is None, "phase %s %s output %d: "
                     "kernel and twin disagree on None" % (tag, k, i))
                continue
            if torch.is_complex(b) or (k in ("fwd_prep_fold", "rfft_ct_half")
                                       and i < 2):
                e = (a - b).abs().max().item()
                need(e <= 2e-3, "phase %s %s spectra err %g" % (tag, k, e))
                err = max(err, e)
            elif k == "fwd_prep_fold":
                tol = dict(rtol=0, atol=1e-4) if i == 2 else \
                    dict(rtol=1e-4, atol=1e-3)
                need(torch.allclose(a, b, **tol), "phase %s %s output %d "
                     "off tolerance" % (tag, k, i))
            elif k == "irfft_ct_fused":
                scale = b.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
                rel = ((a - b).abs() / scale).max().item()
                need(rel <= 2e-5, "phase %s %s err %g of the row max"
                     % (tag, k, rel))
                err = max(err, (a - b).abs().max().item())
            elif not torch.is_floating_point(b):
                need(torch.equal(a.sum(-1), b.sum(-1)), "phase %s %s "
                     "histogram row totals differ" % (tag, k))
                moves = int((a - b).abs().sum().item())
                need(moves <= int(b.sum().item()) // 200000, "phase %s %s "
                     "histogram moves %d" % (tag, k, moves))
            else:
                need(torch.equal(torch.isfinite(a), torch.isfinite(b)),
                     "phase %s %s output %d -inf positions differ"
                     % (tag, k, i))
                f = torch.isfinite(b)
                e = (a[f] - b[f]).abs().max().item() if f.any() else 0.0
                need(e <= 2e-5, "phase %s %s output %d err %g"
                     % (tag, k, i, e))
                err = max(err, e)
        res[k] = dict(err=err)
    say("phase %s: kernels vs twins on the phase's captured inputs: %s"
        % (tag, {k: "%.3g" % v["err"] for k, v in res.items()}))
    return res


def h2_oracle(objs, dtype, tag="H2"):
    """The float64 oracle of every row of a detection that verified a
    hidden event: the row's chunk fetched and prepped as the engine preps
    it (getConData's chunk, _applyFilter at ``dtype``, multiplex), DS by
    ds_numpy; the row's STMP must be a sample of it whose DS is the row's
    within 2e-5 (as phase G2 holds its rows). Returns (rows, largest
    error)."""
    ss, cf = objs["ss"], objs["cfetcher"]
    dets = {}
    for issub in (True, False):
        for sta, st in ss._stations(issub).items():
            for d in st["detectors"]:
                dets[(sta, d["name"])] = d
    filt = ss.clusters.filt
    keys = {r["STATION"]: r for r in ss.clusters.stakey}
    cache = {}
    errs = []
    for ver in objs["res"].Vers:
        for r in ver["Dets"]:
            sta, name = str(r["Sta"]), str(r["Name"])
            U = dets[(sta, name)]["U"]
            hits = []
            for h in (0, 1):
                t0 = (np.floor(r["STMP"] / cf.conDatDuration) - h) * \
                    cf.conDatDuration
                if (sta, t0) not in cache:
                    skey = [keys[sta.split(".")[1]]]
                    chunk = next(cf.getConData(
                        skey, utcstart=t0, utcend=t0 + cf.conDatDuration
                        + cf.conBuff, returnTimes=True), None)
                    cache[(sta, t0)] = None
                    if chunk is not None:
                        st = construct._applyFilter(chunk[0], filt, None,
                                                    dtype)
                        cache[(sta, t0)] = (
                            construct.multiplex(st, NC).astype(np.float64),
                            st[0].stats.starttime.timestamp,
                            st[0].stats.sampling_rate)
                if cache[(sta, t0)] is None:
                    continue
                x64, tstamp, srd = cache[(sta, t0)]
                i = int(round((r["STMP"] - tstamp) * srd))
                ds64 = tds.ds_numpy(x64[max(i - 1, 0) * NC:
                                        (i + 2) * NC + U.shape[1]], U, NC)
                if 0 <= i and i / srd + tstamp == r["STMP"] and \
                        len(ds64) > min(i, 1):
                    hits.append(abs(r["DS"] - ds64[min(i, 1)]))
            need(hits, "phase %s row %s %s at %.3f: no chunk holds it"
                 % (tag, sta, name, r["STMP"]))
            errs.append(min(hits))
    need(errs and max(errs) <= 2e-5, "phase %s planted rows' DS err %s vs "
         "the float64 oracle" % (tag, max(errs) if errs else None))
    return len(errs), max(errs)


def phase_h2(dev, tmpdir):
    """H2: the Case1 path at full width (H2_PARAMS): two stations of two
    station-days of 100 Hz three-channel hour files written, indexed and
    read back, construction at dtype single, detex over every hour, then
    detResults and writeDetections. Gates: every hidden event verified;
    the verified detections' rows against the float64 oracle; one
    waveform file written for every station of every new detection, and
    each listed in the new template key."""
    from detex_torch.data.keys import readKey
    rec, objs, stages = case1_run(H2_PARAMS, "single", tmpdir, dev)
    case1_verified("H2", rec)
    n_rows, err = h2_oracle(objs, "single")
    res = objs["res"]
    evdir = os.path.join(tmpdir, "NewEvents")
    newkey = os.path.join(tmpdir, "NewTemplateKey.csv")
    t0 = time.perf_counter()
    written = res.writeDetections(eventDir=evdir, temkeyPath=newkey)
    stages["writeDetections"] = time.perf_counter() - t0
    stakey = objs["ss"].clusters.stakey
    want = sorted(os.path.join(evdir, "d" + d["Event"], ".".join(
        [s["NETWORK"], s["STATION"], d["Event"], "npz"]))
        for d in res.Dets for s in stakey)
    need(sorted(written) == want and all(os.path.exists(f) for f in want),
         "phase H2 writeDetections wrote %d of %d files"
         % (len(written), len(want)))
    names = {r["NAME"] for r in readKey(newkey, "template")}
    need({"d" + d["Event"] for d in res.Dets} <= names, "phase H2: the new "
         "template key lacks detections")
    objs["rec"] = rec
    say("phase H2: %s, 2 stations x 48 h at 100 Hz: stages (s) %s; %d "
        "detectors, %d ss_df / %d sg_df rows, %d autos, %d new detections, "
        "%d verified of %d hidden; %d verified rows vs float64 oracle DS "
        "err %.3g; writeDetections %d files"
        % (card_line(), json.dumps({k: round(v, 3) for k, v in
                                    stages.items()}),
           sum(len(v) for v in rec["detectors"].values()),
           len(rec["rows"]["ss_df"]), len(rec["rows"]["sg_df"]),
           len(res.Autos), len(res.Dets), len(res.Vers), len(rec["hidden"]),
           n_rows, err, len(written)))
    return dict(stages=stages, oracle_err=err, objs=objs)


def phase_e_kernels(dev, e2):
    """ds_finalize (B10) held against its twin on the inputs ds_bank_demux
    gives it for one E2 chunk (S 16, D 4, L 369,001), outside the counted
    runs, and timed."""
    bank = e2["bank"]
    parts = tds.demux_parts(e2["X"][e2["planted"][0][0]], bank["Ufd2"],
                            bank["sum_u"], bank["d_mask"], bank["n_c"], NC,
                            bank["nfft2"])
    k = ck.ds_finalize(*parts)
    r = ref.ds_finalize_ref(*parts)
    torch.cuda.synchronize()
    need(bool(torch.isfinite(k).all()), "ds_finalize not finite")
    err = (k - r).abs().max().item()
    need(err <= 1e-5, "ds_finalize err %g > 1e-5" % err)
    S, D, L = parts[0].shape
    res = dict(err=err, ms=short_ms(lambda: ck.ds_finalize(*parts)),
               plain_ms=cuda_ms(lambda: ref.ds_finalize_ref(*parts)),
               bound=bound((S * D * L + S * L + 2 * L + S * D) * 4,
                           S * L * (3 * D + 1)))
    say("  ds_finalize cc %s (E2): max_abs_err %.3g; kernel %.3f ms, twin "
        "%.3f ms, library call -, bound %.3f ms (%s) (SM clock %s)"
        % ((S, D, L), err, res["ms"], res["plain_ms"], res["bound"][0],
           res["bound"][1], sm_clock()))
    return {"ds_finalize": res}


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
    # what its transforms read of U and F, nearly all from L2 (its second
    # floor, beside the device-memory bound)
    out["spec_ds_fold"]["l2_bytes"] = B * S * m * D * 2 * 2 * NC * (M + 1) * 4
    s = out["spec_ds_fold"]
    say("phase A anatomy (B=%d): glue %.3f ms; fwd_prep_fold kernel %.3f "
        "ms, twin %.3f ms, spectra max_abs_err %.3g; spec_ds_fold "
        "summary-only kernel %.3f ms, twin %.3f ms, pyr max_abs_err %.3g, "
        "hist moves %d (allowed %d), %.2f GB of spectra read by its %d "
        "transforms (SM clock %s)"
        % (nv.shape[0], out["glue_ms"], out["fwd_prep_fold"]["ms"],
           out["fwd_prep_fold"]["plain_ms"], out["fwd_prep_fold"]["err"],
           s["ms"], s["plain_ms"], s["err"], s["moves"], s["allowed"],
           s["l2_bytes"] / 1e9, B * S * m * D, sm_clock()))
    return out


# ---------------------------------------------------------------------------
# phase I: several devices, the serving artifact's writer, miniSEED
# ---------------------------------------------------------------------------

def i_mesh():
    """Phase I's mesh: every CUDA device when there are several, else
    cuda:0 four times over; with a line saying which."""
    n = torch.cuda.device_count()
    if n > 1:
        return tmesh.make_mesh(), "every CUDA device (%d cards)" % n
    return (tmesh.make_mesh(devices=["cuda:0"] * 4),
            "cuda:0 four times over (one card)")


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def i_run(fn, reps=1):
    """(result, routes, best host seconds of ``reps`` runs after a warm-up
    run) of fn() ending in a synchronize of every card; ``routes`` are the
    names the scans noted in the last run, one a bank, in order."""
    note = tscan._note_route
    noted = []

    def noting(*args, **kw):
        name = note(*args, **kw)
        noted.append(name)
        return name

    out, times = None, []
    tscan._note_route = noting
    try:
        for _ in range(reps + 1):
            del noted[:]
            t0 = time.perf_counter()
            out = fn()
            sync_all()
            times.append(time.perf_counter() - t0)
    finally:
        tscan._note_route = note
    return out, list(noted), min(times[1:])


def i_arrays(out):
    """A list of (hist, maxds, trig_idx, trig_val, trig_count) numpy
    arrays, one a bank: a scan's tensors, or serving's per-bank dicts."""
    if isinstance(out, list):
        return [tuple(r[k] for k in ("hist", "maxds", "trig_idx",
                                     "trig_val", "trig_count"))
                for r in out]
    return [tuple(t.cpu().numpy() for t in out)]


def i_hold(tag, sharded, single, routes_s, routes_1):
    """A sharded scan against the unsharded scan of the same inputs, bank
    by bank: histograms equal, trigger counts and indices equal, maxima
    and trigger values bit-equal where the bank's routes agree (the names
    without "+sharded") and within 1e-6 otherwise. Returns the largest
    difference."""
    banks_s, banks_1 = i_arrays(sharded), i_arrays(single)
    need(len(banks_s) == len(banks_1) == len(routes_s) == len(routes_1),
         "phase %s: %d / %d banks, routes %s / %s" % (
             tag, len(banks_s), len(banks_1), routes_s, routes_1))
    worst, n_trig, n_same = 0.0, 0, 0
    for (h_s, m_s, i_s, v_s, c_s), (h_1, m_1, i_1, v_1, c_1), r_s, r_1 in \
            zip(banks_s, banks_1, routes_s, routes_1):
        same = r_s.replace("+sharded", "") == r_1
        need(np.array_equal(h_s, h_1), "phase %s histograms differ" % tag)
        need(np.array_equal(c_s, c_1) and np.array_equal(i_s, i_1),
             "phase %s trigger counts or indices differ" % tag)
        need(np.array_equal(np.isfinite(m_s), np.isfinite(m_1)),
             "phase %s -inf maxima differ" % tag)
        fin = np.isfinite(m_1)
        err = float(np.abs(m_s[fin] - m_1[fin]).max(initial=0.0))
        k = i_1 >= 0
        err = max(err, float(np.abs(v_s[k] - v_1[k]).max(initial=0.0)))
        if same:
            need(np.array_equal(m_s, m_1) and np.array_equal(v_s[k], v_1[k]),
                 "phase %s maxima not bit-equal on route %s (%g)"
                 % (tag, r_1, err))
        else:
            need(err <= 1e-6, "phase %s maxima or trigger values err %g > "
                 "1e-6 (routes %s, %s)" % (tag, err, r_s, r_1))
        worst = max(worst, err)
        n_trig += int(c_1.sum())
        n_same += same
    say("phase %s: routes sharded %s, unsharded %s; histograms equal, %d "
        "triggers equal, maxima bit-equal on %d of %d banks (the others "
        "within 1e-6; max diff %.3g)" % (tag, routes_s, routes_1, n_trig,
                                         n_same, len(routes_1), worst))
    return worst


def i1_phase_a(dev, mesh):
    """I1 on phase A's 256 two-hour chunks (summary-only, as the engine
    scans), resident on cuda:0 and from a host array (each shard uploaded
    to its card), timed sharded and unsharded; then an odd batch of 7 of
    them with triggers on (padded to a multiple of the mesh)."""
    X, bank, _, planted, _ = phase_a_inputs(dev)
    B = X.shape[0]
    th = np.full(1, 0.5, np.float32)
    kw = dict(max_trig=16, calc_triggers=False)
    st_days = B * 2.0 / 24.0
    rates = {}
    out_s, routes_s, t_s = i_run(lambda: tscan.scan_chunks(
        X, bank, th, NC, int(20 * SR), mesh=mesh, **kw), reps=3)
    out_1, routes_1, t_1 = i_run(lambda: tscan.scan_chunks(
        X, bank, th, NC, int(20 * SR), **kw), reps=3)
    i_hold("I1 phase A (256 x 2 h)", out_s, out_1, routes_s, routes_1)
    rates["device"] = (st_days / t_s, st_days / t_1)
    Xh = X.cpu().numpy()
    t0 = time.perf_counter()
    torch.from_numpy(Xh).to(dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    out_h, _, th_s = i_run(lambda: tscan.scan_chunks(
        Xh, bank, th, NC, int(20 * SR), mesh=mesh, **kw), reps=2)
    i_hold("I1 phase A from a host array", out_h, out_1, routes_s,
           routes_1)
    _, _, th_1 = i_run(lambda: tscan.scan_chunks(
        Xh, bank, th, NC, int(20 * SR), **kw), reps=2)
    rates["host"] = (st_days / th_s, st_days / th_1)
    say("phase I1 phase A: %d-entry mesh, s/launch sharded %.6f, unsharded "
        "%.6f: %.3f against %.3f station-days/s on the card(s); from a "
        "host array (pageable upload of %.0f MB: %.6f s alone) sharded "
        "%.6f s, unsharded %.6f s: %.3f against %.3f station-days/s (%s)"
        % (mesh.size, t_s, t_1, rates["device"][0], rates["device"][1],
           Xh.nbytes / 1e6, t_up, th_s, th_1, rates["host"][0],
           rates["host"][1], card_line()))
    del out_s, out_1, out_h, Xh
    odd = X[:7]
    kw = dict(max_trig=16)
    out_s, routes_s, _ = i_run(lambda: tscan.scan_chunks(
        odd, bank, th, NC, int(20 * SR), mesh=mesh, **kw))
    out_1, routes_1, _ = i_run(lambda: tscan.scan_chunks(
        odd, bank, th, NC, int(20 * SR), **kw))
    i_hold("I1 odd batch (7 chunks, triggers on)", out_s, out_1, routes_s,
           routes_1)
    need(int(out_s[4][5, 0]) >= 1, "phase I1 odd batch: planted event in "
         "chunk 5 missed")
    return dict(rates=rates, s_per_launch=(t_s, t_1),
                host_s=(th_s, th_1), upload_s=t_up)


def i1_f2(dev, mesh, n_chunks=8, seed=62, n_det=1000):
    """I1 on F2's 1000-template station (8 chunks, route
    "blocked-fused-net+fusedprep"), summary-only as the engine scans."""
    rng = np.random.default_rng(seed)
    L = int(F_SEC * SR)
    n = int(30 * SR * NC)
    dets = f_detectors(rng, "nw", n_det, 1, n, False)
    events = [(b % n_chunks, s % n_det, at) for b, s, at in (
        (0, 3, 40000), (2, 517, 200000), (5, 768, 9000), (7, 999, 300000))]
    planted = f_plant(dets, events, n)
    X = np.stack([construct.multiplex(construct._applyFilter(
        f_stream(f_chunk(seed, b, L, planted), b, SR), None, None,
        "single"), NC) for b in range(n_chunks)])
    bank = tds.build_bank([d["U"] for d in dets], NC, X.shape[1], dev,
                          pad_S=tds.pad_rows(len(dets)),
                          min_dmax=tds.pad_dims(1))
    th = np.full(int(bank["sum_u"].shape[0]), np.inf, np.float32)
    th[:len(dets)] = 0.3
    kw = dict(buff_samps=1, max_trig=1, calc_triggers=False)
    out_s, routes_s, t_s = i_run(lambda: tscan.scan_chunks(
        X, bank, th, NC, mesh=mesh, **kw))
    out_1, routes_1, t_1 = i_run(lambda: tscan.scan_chunks(
        X, bank, th, NC, **kw))
    i_hold("I1 F2 (1000 templates)", out_s, out_1, routes_s, routes_1)
    for b, s, _ in events:
        need(float(out_s[1][b, s]) > 0.3, "phase I1 F2 event (%d, %d) below "
             "threshold" % (b, s))
    say("phase I1 F2: s sharded %.6f, unsharded %.6f (host array of %d "
        "chunks)" % (t_s, t_1, n_chunks))
    return t_s, t_1


def i1_raw(dev, mesh, tmpdir):
    """I1 on E1's raw overlap-save serving batch (devicePrep) and E3's
    raw-demux batch with one ragged chunk."""
    e1 = phase_e1_setup(dev, tmpdir)
    out_s, routes_s, _ = i_run(lambda: serving.scan_station_raw(
        e1["dep"], SERVE_STA, e1["X"], max_trig=8, mesh=mesh))
    out_1, routes_1, _ = i_run(lambda: serving.scan_station_raw(
        e1["dep"], SERVE_STA, e1["X"], max_trig=8))
    i_hold("I1 E1 (devicePrep serving)", out_s, out_1, routes_s, routes_1)
    counts = out_s[0]["trig_count"]
    for b, s in e1["planted"]:
        need(counts[b, s] == 1, "phase I1 E1 (%d, %d) not triggered"
             % (b, s))
    del e1
    e3 = phase_e3_setup(dev)
    th = np.full(16, 0.5, np.float32)
    buff = int(20 * RAW_SR / DEC)
    args = (e3["X"], e3["lens"], e3["H"], e3["bank"], th, NC, buff)
    out_s, routes_s, _ = i_run(lambda: tscan.scan_chunks_raw(
        *args, max_trig=8, dec=DEC, mesh=mesh))
    out_1, routes_1, _ = i_run(lambda: tscan.scan_chunks_raw(
        *args, max_trig=8, dec=DEC))
    i_hold("I1 E3 (raw-demux, chunk 5 ragged)", out_s, out_1, routes_s,
           routes_1)
    for b, s in e3["planted"]:
        need(int(out_s[4][b, s]) == 1, "phase I1 E3 (%d, %d) not triggered"
             % (b, s))


def i2_engine(dev, mesh, tmpdir):
    """I2: F1's station-day through detect.detex on the engine's mesh and
    again with DETEX_TORCH_MESH=0: identical SQLite rows and histograms.
    With one card the engine's mesh (every CUDA device) would be none, so
    parallel/scan.engine_mesh is handed phase I's mesh for the first run."""
    _, _, inputs = f1_setup()
    real = tscan.engine_mesh
    one_card = torch.cuda.device_count() < 2
    runs = {}
    for tag in ("mesh", "single"):
        db = os.path.join(tmpdir, "i2_%s.db" % tag)
        if tag == "mesh":
            os.environ.pop("DETEX_TORCH_MESH", None)
            if one_card:
                tscan.engine_mesh = lambda device=None: mesh
        else:
            os.environ["DETEX_TORCH_MESH"] = "0"
        tscan.ROUTE_COUNTS.clear()
        try:
            hists, wall = f1_run(dev, db, inputs)
        finally:
            tscan.engine_mesh = real
            os.environ.pop("DETEX_TORCH_MESH", None)
        rows = {t: util.loadSQLite(db, t, columns=True)
                for t in ("ss_df", "sg_df")}
        runs[tag] = (rows, hists, wall, dict(tscan.ROUTE_COUNTS))
    (rows_m, hist_m, wall_m, routes_m) = runs["mesh"]
    (rows_1, hist_1, wall_1, routes_1) = runs["single"]
    need(any(r.endswith("+sharded") for r in routes_m)
         and not any("+sharded" in r for r in routes_1),
         "phase I2 routes: mesh %s, single %s" % (routes_m, routes_1))
    n_rows = 0
    for t in rows_m:
        a, b = rows_m[t], rows_1[t]
        need(sorted(a) == sorted(b), "phase I2 %s columns differ" % t)
        for col in a:
            x, y = np.asarray(a[col]), np.asarray(b[col])
            same = (np.array_equal(x, y, equal_nan=True)
                    if x.dtype.kind == "f" else list(x) == list(y))
            need(same, "phase I2 %s column %s differs" % (t, col))
        n_rows += len(a["STMP"])
    for k in hist_m:
        for name, h in hist_m[k].items():
            need(np.array_equal(h, hist_1[k][name]),
                 "phase I2 histogram of %s differs" % name)
    say("phase I2: F1's station-day through detect.detex on a %d-entry mesh "
        "%.3f s, with DETEX_TORCH_MESH=0 %.3f s: %d rows identical (STMP "
        "and DS equal), histograms equal; routes %s (%s)"
        % (mesh.size, wall_m, wall_1, n_rows, sorted(routes_m),
           card_line()))
    return wall_m, wall_1


def i3_serving(dev, mesh, h2, tmpdir, n_hours=8):
    """I3: export_detectors of H2's SubSpace, load_detectors, and
    scan_station on n_hours of its first station's continuous chunks
    (fetched, filtered and multiplexed as the engine does), with the mesh
    and without, held as I1 holds its cases."""
    ss, cf = h2["ss"], h2["cfetcher"]
    sta = ss.Stations[0]
    path = serving.export_detectors(ss, os.path.join(tmpdir, "h2.npz"))
    dep = serving.load_detectors(path, chunk_sec=cf.conDatDuration,
                                 conBuff=cf.conBuff, device=dev)
    names = [nm for b in dep[sta]["banks"] for nm in b["names"]]
    want = [r["Name"] for r in ss.subspaces.get(sta, [])
            if r["SVDdefined"]] + [r["Name"] for r in ss.singles.get(sta, [])
                                   if r["SampleTrims"]]
    need(sorted(names) == sorted(want), "phase I3 artifact detectors %s, "
         "SubSpace %s" % (sorted(names), sorted(want)))
    skey = [r for r in ss.clusters.stakey if r["STATION"] == sta.split(".")[1]]
    chunks = []
    for st, _, _ in cf.getConData(skey, returnTimes=True):
        if st is None:
            continue
        st = construct._applyFilter(st, ss.clusters.filt, None, "single")
        chunks.append(construct.multiplex(st, NC))
        if len(chunks) == n_hours:
            break
    L = max(len(c) for c in chunks)
    X = np.zeros((len(chunks), L), np.float32)
    for b, c in enumerate(chunks):
        X[b, :len(c)] = c
    lens = [len(c) for c in chunks]
    out_s, routes_s, _ = i_run(lambda: serving.scan_station(
        dep, sta, X, valid_lens=lens, mesh=mesh))
    out_1, routes_1, _ = i_run(lambda: serving.scan_station(
        dep, sta, X, valid_lens=lens))
    i_hold("I3 serving (H2's artifact, %d detectors, %d hours of %s)"
           % (len(names), len(chunks), sta), out_s, out_1, routes_s,
           routes_1)


def i4_mseed(dev, h2, tmpdir):
    """I4: H2's first station's hour files written again as miniSEED
    (the lossless automatic encoding of their samples) and read back
    sample for sample; that directory indexed, fetched through
    'dir' and scanned by SubSpace.detex on that station, its rows
    identical to H2's; one hour of 3 channels of 100 Hz integer counts
    through STEIM2 and STEIM1 bit for bit; write and read MB/s."""
    from detex_torch import subspace
    from detex_torch.data import fetcher as getdata
    from detex_torch.data import mseed, waveio
    need(mseed.available(), "phase I4: the native host library did not build")
    ss, paths, rec = h2["ss"], h2["paths"], h2["rec"]
    sta = ss.Stations[0]
    src = os.path.join(paths["conDir"], sta)
    dst_root = os.path.join(tmpdir, "mseed", os.path.basename(
        paths["conDir"].rstrip(os.sep)))
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(src)
                   for f in fs if f.endswith(".npz"))
    need(len(files) == 48, "phase I4: %d hour files of %s" % (len(files), sta))
    t_w = t_r = 0.0
    nbytes = 0
    for f in files:
        st = waveio.read(f)
        out = os.path.join(dst_root, os.path.relpath(f, paths["conDir"]))
        out = out[:-len(".npz")] + ".msd"
        os.makedirs(os.path.dirname(out), exist_ok=True)
        t0 = time.perf_counter()
        mseed.write_mseed(st, out)
        t_w += time.perf_counter() - t0
        t0 = time.perf_counter()
        back = waveio.read(out)
        t_r += time.perf_counter() - t0
        need(len(back) == len(st), "phase I4 %s: %d traces back of %d"
             % (out, len(back), len(st)))
        for a, b in zip(back, st):
            need(a.id == b.id and a.stats.starttime == b.stats.starttime
                 and a.stats.sampling_rate == b.stats.sampling_rate
                 and np.array_equal(a.data, b.data.astype(np.float64)),
                 "phase I4 %s: trace %s differs" % (out, b.id))
            nbytes += b.data.nbytes
    say("phase I4: %d hour files of %s (%s samples) as miniSEED %s: write "
        "%.1f MB/s, read %.1f MB/s (%.0f MB of samples)"
        % (len(files), sta, st[0].data.dtype,
           mseed._auto_encoding(st[0].data), nbytes / 1e6 / t_w,
           nbytes / 1e6 / t_r, nbytes / 1e6))
    t0 = time.perf_counter()
    getdata.indexDirectory(dst_root)
    t_idx = time.perf_counter() - t0
    mfetch = getdata.DataFetcher("dir", directoryName=dst_root)
    base = subspace._fetcher_con_chunks(mfetch, ss.clusters.stakey, None,
                                        None)
    db = os.path.join(tmpdir, "i4.db")
    t0 = time.perf_counter()
    ss.detex(subspaceDB=db, chunks=lambda s: base(s) if s == sta
             else iter(()), **H2_PARAMS["detex"])
    t_det = time.perf_counter() - t0
    n_rows = 0
    for i, table in enumerate(("ss_df", "sg_df")):
        got = [[str(r["Sta"]), str(r["Name"]), float(r["STMP"]),
                float(r["DS"]), float(r["Mag"])]
               for r in util.loadSQLite(db, table) or []]
        want = [r for r in rec["rows"][table] if r[0] == sta]
        need(got == want, "phase I4 %s: %d rows from miniSEED, %d from npz; "
             "first differing %s" % (table, len(got), len(want), next(
                 ((a, b) for a, b in zip(got, want) if a != b), None)))
        n_rows += len(got)
    need(n_rows > 0, "phase I4: no rows for %s" % sta)
    rng = np.random.default_rng(101)
    counts = [np.cumsum(rng.integers(-2000, 2000, 360000)).astype(np.float64)
              for _ in range(NC)]
    st = Stream([Trace(c, dict(network="XX", station="M", channel="BH" + z,
                               sampling_rate=SR, starttime=F_T0))
                 for c, z in zip(counts, "ENZ")])
    steim = []
    for enc in ("STEIM2", "STEIM1"):
        p = os.path.join(tmpdir, "counts_%s.msd" % enc)
        t0 = time.perf_counter()
        mseed.write_mseed(st, p, encoding=enc)
        tw = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mseed.read_mseed(p)
        tr = time.perf_counter() - t0
        need(len(back) == NC and all(
            np.array_equal(a.data, b.data) for a, b in zip(back, st)),
             "phase I4 %s round trip not bit for bit" % enc)
        mb = sum(c.size for c in counts) * 4 / 1e6
        steim.append("%s %.1f MB/s write, %.1f MB/s read, %.2f bytes a "
                     "sample" % (enc, mb / tw, mb / tr,
                                 os.path.getsize(p) / (mb * 1e6 / 4)))
    say("phase I4: the miniSEED directory indexed in %.3f s and scanned by "
        "SubSpace.detex in %.3f s: %d rows of %s identical to H2's; one "
        "hour x 3 channels of integer counts bit for bit: %s"
        % (t_idx, t_det, n_rows, sta, "; ".join(steim)))
    return dict(write_mb_s=nbytes / 1e6 / t_w, read_mb_s=nbytes / 1e6 / t_r)


def phase_i(dev, h2, tmpdir):
    """Phase I: I1 the sharded scans against the unsharded ones, I2 the
    engine on the mesh, I3 serving from H2's exported artifact, I4
    miniSEED."""
    mesh, how = i_mesh()
    say("phase I: mesh of %d entries, %s: %s" % (
        mesh.size, how, [str(d) for d in mesh]))
    out = dict(mesh_size=mesh.size, a=i1_phase_a(dev, mesh))
    torch.cuda.empty_cache()
    out["f2_s"] = i1_f2(dev, mesh)
    torch.cuda.empty_cache()
    i1_raw(dev, mesh, tmpdir)
    torch.cuda.empty_cache()
    out["engine_s"] = i2_engine(dev, mesh, tmpdir)
    i3_serving(dev, mesh, h2, tmpdir)
    out["mseed"] = i4_mseed(dev, h2, tmpdir)
    return out


def hold_off_device(dev):
    """B1, B2, B6, B7 and B10 held against their twins on ``dev`` (a card
    other than cuda:0), each where the sharded scans launch it: B1 and B2
    at phase A's geometry cut to 16 chunks and at phase B's, B6 on D3's
    frames (90 s templates, n_c > W), B7 on one chunk of eight 30 s
    templates, B10 on one chunk of a full-length bank."""
    with torch.cuda.device(dev):
        n30 = int(30 * SR * NC)
        errs = {}
        for r in (kernel_vs_twin(dev, 16, int(7200 * SR * NC), n30, 1, 4,
                                 "sub", 91),
                  kernel_vs_twin(dev, 8, int(3720 * SR * NC), n30, 128, 1,
                                 "net", 92)):
            for k, v in r.items():
                errs[k] = max(errs.get(k, 0.0), v["err"])
        rng = np.random.default_rng(93)
        g = torch.Generator(device=dev).manual_seed(93)
        x = torch.randn((2, int(7200 * SR * NC)), generator=g, device=dev)
        blk, n_c = 16384, int(90 * SR)
        _, _, _, W, _ = tds._os_geometry(x.shape[1] // NC, n_c, blk)
        xq, _ = tds.standardize_demux(x, n_c, NC, blk)
        frames = xq.unfold(2, blk, W).reshape(-1, blk).contiguous()
        errs["rfft_ct_half"] = compare_half(frames, blk)["err"]
        del xq, frames
        xc = x[0, :int(3720 * SR * NC)]
        bank = tds.build_bank([basis(rng, 1, n30) for _ in range(8)], NC,
                              xc.shape[0], dev)
        fin = chunk_finalize_inputs(bank, xc)
        nv = torch.tensor([fin[-1]], dtype=torch.int32, device=dev)
        errs["ds_finalize_os_scan"] = compare_os_scan(fin, nv, NBIN)["err"]
        del fin
        full = tds.build_bank([basis(rng, 2, n30) for _ in range(4)], NC,
                              xc.shape[0], dev, prefer_os=False)
        parts = tds.demux_parts(xc, full["Ufd2"], full["sum_u"],
                                full["d_mask"], full["n_c"], NC,
                                full["nfft2"])
        k = ck.ds_finalize(*parts)
        r = ref.ds_finalize_ref(*parts)
        torch.cuda.synchronize(dev)
        errs["ds_finalize"] = (k - r).abs().max().item()
        need(errs["ds_finalize"] <= 1e-5, "ds_finalize on %s err %g"
             % (dev, errs["ds_finalize"]))
    say("kernels off cuda:0: B1, B2, B6, B7, B10 against their twins on %s "
        "(%s): %s" % (dev, torch.cuda.get_device_name(dev),
                      {k: "%.3g" % v for k, v in errs.items()}))
    return errs


# ---------------------------------------------------------------------------
# phase J: the engine's classify and UTC-save modes on the per-chunk path,
# saved objects, quality_check
# ---------------------------------------------------------------------------

J_STALTA = dict(trigCon=1, triggerLTATime=60, triggerSTATime=2,
                staltaThreshold=4.0)


def j_prepped(st, ss, dtype="single"):
    """A chunk prepped as the engine preps it (_applyFilter at ``dtype``,
    multiplex): (multiplexed samples, start timestamp, sampling rate)."""
    st = construct._applyFilter(st, ss.clusters.filt, ss.clusters.decimate,
                                dtype)
    return (construct.multiplex(st, NC), st[0].stats.starttime.timestamp,
            st[0].stats.sampling_rate)


def j_detectors(ss, issubspace=True):
    """{(sta, name): U} of the engine's detectors of ``ss``."""
    return {(sta, d["name"]): d["U"]
            for sta, st in ss._stations(issubspace).items()
            for d in st["detectors"]}


def j_in(workdir, fn):
    """fn() run in ``workdir`` (the modes write their tables to the
    working directory), and its wall seconds."""
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def j1_classify(h2, tmpdir):
    """J1: SubSpace.detex(classifyEvents=<the template key>) over every
    station: one EventCors_<sta>.pkl a station with a row for each
    (event, subspace); each row's DS within 2e-5 of the float64 oracle
    (ds_numpy) on the same multiplexed event chunk; every training event
    classified into its own subspace: its DS there above that subspace's
    threshold and above its DS on every other subspace of the station
    (the lowest such DS is printed: a training event's DS on its own
    subspace is the energy the basis captures of it, which the 0.9
    average capture of SVD's selectValue does not bound per event)."""
    from detex_torch.data.keys import readKey
    ss, paths = h2["ss"], h2["paths"]
    wd = os.path.join(tmpdir, "j1")
    wall = j_in(wd, lambda: ss.detex(
        subspaceDB="j1.db", classifyEvents=paths["templateKey"],
        useSingles=False))
    fet = ss.clusters.fetcher
    temkey = readKey(paths["templateKey"], "template")
    dets = j_detectors(ss)
    n_rows, err = 0, 0.0
    low, own = [], []
    for sta in ss.ssStations:
        rows = util.readRows(os.path.join(wd, "EventCors_%s.pkl" % sta))
        need(all(list(r) == detect.EVENT_COR_COLS for r in rows),
             "phase J1 %s: EventCors columns" % sta)
        got = {(r["Name"], r["TimeStamp"]): r["DS"] for r in rows}
        names = [r["Name"] for r in ss.subspaces[sta]]
        skey = [r for r in ss.clusters.stakey
                if r["STATION"] == sta.split(".")[1]]
        n_ev = 0
        for st, ev in fet.getTemData(temkey, skey, returnName=True):
            x, tstamp, _ = j_prepped(st, ss)
            n_ev += 1
            for name in names:
                need((name, tstamp) in got, "phase J1 %s: no row for %s on "
                     "%s" % (sta, name, ev))
                ds64 = tds.ds_numpy(x, dets[(sta, name)], NC).max()
                err = max(err, abs(got[(name, tstamp)] - ds64))
            for row in ss.subspaces[sta]:
                if ev not in row["Events"]:
                    continue
                mine = got[(row["Name"], tstamp)]
                own.append(mine)
                if mine <= row["Threshold"] or any(
                        got[(nm, tstamp)] >= mine for nm in names
                        if nm != row["Name"]):
                    low.append((sta, row["Name"], ev, mine, {
                        nm: got[(nm, tstamp)] for nm in names}))
        need(len(rows) == n_ev * len(names) and n_ev == len(temkey),
             "phase J1 %s: %d rows for %d events x %d subspaces"
             % (sta, len(rows), n_ev, len(names)))
        n_rows += len(rows)
    need(err <= 2e-5, "phase J1 classify DS err %g vs the float64 oracle"
         % err)
    need(own and not low, "phase J1 training events not classified into "
         "their own subspace: %s" % low)
    say("phase J1: classify %d events x %d stations: %d EventCors rows, DS "
        "err vs float64 %.3g; every training event (%d) classified into its "
        "own subspace, its DS there %.4f to %.4f; %.3f s (%s)"
        % (len(temkey), len(ss.ssStations), n_rows, err, len(own),
           min(own), max(own), wall, card_line()))
    return dict(wall=wall, err=err)


def j_hours(h2):
    """Station-hours of continuous data the engine scans."""
    cf, ss = h2["cfetcher"], h2["ss"]
    n = 0
    for sta in ss.Stations:
        skey = [r for r in ss.clusters.stakey
                if r["STATION"] == sta.split(".")[1]]
        for r in skey:
            span = (UTCDateTime(r["ENDTIME"]).timestamp -
                    UTCDateTime(r["STARTTIME"]).timestamp)
            n += span / cf.conDatDuration
    return n


def j2_utc_saves(h2, tmpdir):
    """J2: utcSaves at the hidden events' times: every saved row spans its
    time, its MPcon is the host multiplex of the same hour, its SSdetect
    within 2e-5 of the float64 oracle with the argmax at the oracle's (or
    at a near tie of it, printed). Then classify and utcSaves together
    with the template fetcher's conBuff at 5 s: every DS vector shorter
    than at the default conBuff by int((duration - 5) * sr) samples."""
    ss, cf, cat = h2["ss"], h2["cfetcher"], h2["cat"]
    times = [e["time"] for e in cat.hidden]
    wd = os.path.join(tmpdir, "j2")
    wall = j_in(wd, lambda: ss.detex(subspaceDB="j2.db", utcSaves=times,
                                     useSingles=False))
    rows = util.readRows(os.path.join(wd, "UTCsaves.pkl"))
    dets = j_detectors(ss)
    need(all(list(r) == detect.UTC_SAVE_COLS for r in rows),
         "phase J2 UTCsaves columns")
    covered = set()
    keys = {r["STATION"]: r for r in ss.clusters.stakey}
    cache = {}
    err, ties = 0.0, 0
    for r in rows:
        need(all(r["TS1"] <= t <= r["TS2"] for t in r["utcSaves"]),
             "phase J2 row %s %s spans %.3f-%.3f, not %s" % (
                 r["Station"], r["Name"], r["TS1"], r["TS2"],
                 r["utcSaves"]))
        covered.update((r["Station"], float(t)) for t in r["utcSaves"])
        key = (r["Station"], r["TS1"])
        if key not in cache:
            t0 = np.floor(r["TS1"] / cf.conDatDuration) * cf.conDatDuration
            st = next(cf.getConData([keys[r["Station"].split(".")[1]]],
                                    utcstart=t0, utcend=t0 +
                                    cf.conDatDuration + cf.conBuff), None)
            need(st is not None, "phase J2: no chunk at %.0f" % t0)
            cache[key] = j_prepped(st, ss)[0]
        x = cache[key]
        need(np.array_equal(r["MPcon"], x), "phase J2 %s %s: MPcon is not "
             "the host multiplex of its hour" % (r["Station"], r["Name"]))
        ds64 = tds.ds_numpy(x, dets[(r["Station"], r["Name"])], NC)
        need(ds64.shape == r["SSdetect"].shape, "phase J2 SSdetect length "
             "%d, oracle %d" % (len(r["SSdetect"]), len(ds64)))
        err = max(err, float(np.abs(r["SSdetect"] - ds64).max()))
        i, i64 = int(np.argmax(r["SSdetect"])), int(np.argmax(ds64))
        if i != i64:
            need(ds64[i64] - ds64[i] <= 2e-5, "phase J2 %s %s argmax %d, "
                 "oracle %d (%.6f against %.6f)" % (
                     r["Station"], r["Name"], i, i64, ds64[i], ds64[i64]))
            ties += 1
            say("phase J2 %s %s: argmax %d, oracle %d: a near tie (%.3g)"
                % (r["Station"], r["Name"], i, i64, ds64[i64] - ds64[i]))
    need(err <= 2e-5, "phase J2 SSdetect err %g vs the float64 oracle"
         % err)
    need({t for _, t in covered} == set(times) and
         len(covered) == len(times) * len(ss.ssStations),
         "phase J2: saved %d (station, time) pairs of %d"
         % (len(covered), len(times) * len(ss.ssStations)))
    # classify + utcSaves with a short template buffer
    fet = ss.clusters.fetcher
    row0 = ss.subspaces[ss.ssStations[0]][0]
    ev0 = row0["Events"][0]
    sr = row0["Stats"][ev0]["sampling_rate"]
    t_ev = UTCDateTime(h2["clust"].templates[ev0]["time"]).timestamp + 3
    dur = (row0["SampleTrims"]["Endtime"] -
           row0["SampleTrims"]["Starttime"]) / (sr * NC)
    lens = {}
    old = fet.conBuff
    try:
        for buff in (old, 5.0):
            fet.conBuff = buff
            wdb = os.path.join(tmpdir, "j2_%g" % buff)
            j_in(wdb, lambda: ss.detex(
                subspaceDB="c.db", classifyEvents=h2["paths"]["templateKey"],
                utcSaves=[t_ev], useSingles=False))
            saved = util.readRows(os.path.join(wdb, "UTCsaves.pkl"))
            lens[buff] = {(r["Station"], r["Name"]): len(r["SSdetect"])
                          for r in saved}
    finally:
        fet.conBuff = old
    cut = int((dur - 5.0) * sr)
    need(lens[old] and sorted(lens[old]) == sorted(lens[5.0]) and all(
        lens[old][k] - lens[5.0][k] == cut for k in lens[old]),
        "phase J2 conBuff trim: lengths %s and %s, expected a cut of %d"
        % (lens[old], lens[5.0], cut))
    rate = j_hours(h2) / wall
    say("phase J2: utcSaves at %d hidden-event times: %d rows, MPcon the "
        "host multiplex, SSdetect err vs float64 %.3g, %d near-tie argmax; "
        "%.3f s, %.3f station-hours/s; classify at conBuff 5 s cuts %d "
        "samples from %d DS vectors (%s)" % (
            len(times), len(rows), err, ties, wall, rate, cut,
            len(lens[5.0]), card_line()))
    return dict(wall=wall, rate=rate, err=err)


def j3_unbatched(h2, tmpdir):
    """J3: H2's detex on the per-chunk path (batchSize 1) against H2's
    batched rows (same rows, STMP exact, DS within 2e-5); then trigCon 1
    (STA/LTA of the DS) at batchSize 1: every row's DS_STALTA above the
    threshold and every hidden event inside a row's window (10 s margin,
    as phase H verifies them)."""
    ss, cat = h2["ss"], h2["cat"]
    hours = j_hours(h2)
    out = {}
    db1 = os.path.join(tmpdir, "j3_b1.db")
    out["batch1"] = j_in(tmpdir, lambda: ss.detex(
        subspaceDB=db1, batchSize=1, **H2_PARAMS["detex"]))
    n_rows, err = 0, 0.0
    for table in ("ss_df", "sg_df"):
        def srt(rows):
            return sorted(rows, key=lambda r: (r["Sta"], r["Name"],
                                               r["STMP"]))
        got = srt(util.loadSQLite(db1, table) or [])
        want = srt(util.loadSQLite(h2["db"], table) or [])
        need([(r["Sta"], r["Name"], r["STMP"]) for r in got] ==
             [(r["Sta"], r["Name"], r["STMP"]) for r in want],
             "phase J3 %s: %d per-chunk rows, %d batched, (Sta, Name, "
             "STMP) differ" % (table, len(got), len(want)))
        if got:
            err = max(err, max(abs(a["DS"] - b["DS"])
                               for a, b in zip(got, want)))
        n_rows += len(got)
    need(n_rows > 0 and err <= 2e-5, "phase J3 batchSize 1: %d rows, DS "
         "err %g against the batched rows" % (n_rows, err))
    db2 = os.path.join(tmpdir, "j3_tc1.db")
    out["trigcon1"] = j_in(tmpdir, lambda: ss.detex(
        subspaceDB=db2, batchSize=1, useSingles=False, **J_STALTA))
    rows = util.loadSQLite(db2, "ss_df") or []
    need(rows and all(r["DS_STALTA"] > J_STALTA["staltaThreshold"]
                      for r in rows), "phase J3 trigCon 1: %d rows, DS_STALTA"
         " at or under the threshold" % len(rows))
    missed = [e["time"] for e in cat.hidden if not any(
        r["MSTAMPmin"] - 10 <= e["time"] <= r["MSTAMPmax"] + 10
        for r in rows)]
    need(not missed, "phase J3 trigCon 1 misses hidden events %s" % missed)
    say("phase J3: per-chunk path (batchSize 1) %.3f s, %.3f station-hours/s"
        " (batched H2 detex %.3f s, %.3f station-hours/s): %d rows equal to "
        "the batched rows, DS err %.3g; trigCon 1 %.3f s, %.3f "
        "station-hours/s, %d rows, every hidden event among them (%s)"
        % (out["batch1"], hours / out["batch1"], h2["detex_s"],
           hours / h2["detex_s"], n_rows, err, out["trigcon1"],
           hours / out["trigcon1"], len(rows), card_line()))
    return dict(err=err, rates={k: hours / v for k, v in out.items()},
                walls=out)


FOREIGN_PICKLE = b"\x80\x02cdetex_tpu.subspace\nClusterStream\nq\x00)\x81q\x01."


def j4_objects(dev, h2, tmpdir, n_hours=8):
    """J4: ClusterStream.write -> util.loadClusters -> createSubSpace(clust
    = the path), its rows equal to createSubSpace on the cluster in
    memory; SubSpace.write -> util.loadSubSpace, whose detex over n_hours
    of the first station gives the original's rows; a pickle naming a
    detex_tpu class refused without importing detex_tpu."""
    import sys
    from detex_torch import subspace
    clust, ss, cf = h2["clust"], h2["ss"], h2["cfetcher"]
    t0 = time.perf_counter()
    clust.write()
    back = util.loadClusters(clust.filename, device=dev)
    need([c.clusts for c in back.clusters] == [c.clusts for c in
                                                clust.clusters],
         "phase J4 loaded clusters differ")
    kw = dict(dtype="single", conDatFetcher=cf, **H2_PARAMS["createSubSpace"])
    a = construct.createSubSpace(clust=clust.filename, device=dev, **kw)
    b = construct.createSubSpace(clust=clust, **kw)
    for sta in b.subspaces:
        for ra, rb in zip(a.subspaces[sta], b.subspaces[sta]):
            need(ra["Events"] == rb["Events"] and all(
                np.array_equal(ra["AlignedTD"][e], rb["AlignedTD"][e])
                for e in rb["Events"]), "phase J4 %s %s: createSubSpace "
                 "from the path differs" % (sta, rb["Name"]))
    path = os.path.join(tmpdir, "j4_subspace.pkl")
    ss.write(path)
    ss2 = util.loadSubSpace(path, device=dev)
    t_io = time.perf_counter() - t0
    sta = ss.Stations[0]
    skey = [r for r in ss.clusters.stakey
            if r["STATION"] == sta.split(".")[1]]
    start = UTCDateTime(skey[0]["STARTTIME"]).timestamp
    base = subspace._fetcher_con_chunks(cf, ss.clusters.stakey, start,
                                        start + n_hours * cf.conDatDuration)

    def chunks(s):
        return base(s) if s == sta else iter(())
    tables = []
    for obj, tag in ((ss, "orig"), (ss2, "loaded")):
        db = os.path.join(tmpdir, "j4_%s.db" % tag)
        obj.detex(subspaceDB=db, chunks=chunks, **H2_PARAMS["detex"])
        tables.append({t: util.loadSQLite(db, t, columns=True)
                       for t in ("ss_df", "sg_df")})
    n_rows = 0
    for t in tables[0]:
        a, b = tables[0][t], tables[1][t]
        need(sorted(a) == sorted(b) and all(
            np.array_equal(np.asarray(a[c]), np.asarray(b[c]),
                           equal_nan=np.asarray(a[c]).dtype.kind == "f")
            for c in a), "phase J4 %s: the loaded SubSpace's rows differ"
             % t)
        n_rows += len(a["STMP"])
    need(n_rows > 0, "phase J4: no rows in %d hours of %s" % (n_hours, sta))
    bad = os.path.join(tmpdir, "j4_foreign.pkl")
    with open(bad, "wb") as fh:
        fh.write(FOREIGN_PICKLE)
    try:
        util.loadClusters(bad, device=dev)
    except NotImplementedError:
        pass
    else:
        need(False, "phase J4: a detex_tpu pickle was not refused")
    need("detex_tpu" not in sys.modules, "phase J4: detex_tpu was imported")
    say("phase J4: ClusterStream and SubSpace written and loaded (%.3f s, "
        "%.1f MB and %.1f MB), createSubSpace from the path equal to the "
        "in-memory one, %d rows of %d hours of %s identical after the load, "
        "a detex_tpu pickle refused" % (
            t_io, os.path.getsize(clust.filename) / 1e6,
            os.path.getsize(path) / 1e6, n_rows, n_hours, sta))


def j5_quality(h2):
    """J5: check_data_quality on H2's continuous directory: every file
    passes."""
    from detex_torch import quality_check
    rows = quality_check.check_data_quality(h2["paths"]["conDir"])
    bad = [r["FileName"] for r in rows if not r["ok"]]
    need(rows and not bad, "phase J5: %d files, failing %s"
         % (len(rows), bad))
    say("phase J5: check_data_quality: %d files, all ok" % len(rows))
    return len(rows)


def phase_j(dev, h2, tmpdir):
    """Phase J: J1 classify, J2 UTC saves, J3 the per-chunk path against
    the batched one, J4 saved objects, J5 quality_check, on H2's
    objects (``h2`` phase_h2's result)."""
    h2 = dict(h2["objs"], detex_s=h2["stages"]["detex"])
    t0 = time.perf_counter()
    out = dict(j1=j1_classify(h2, tmpdir), j2=j2_utc_saves(h2, tmpdir),
               j3=j3_unbatched(h2, tmpdir))
    j4_objects(dev, h2, tmpdir)
    out["j5"] = j5_quality(h2)
    out["wall"] = time.perf_counter() - t0
    say("phase J: %.1f s with its checks (%s)" % (out["wall"], card_line()))
    return out


# the per-chunk path's kernels (ops/ds.run_bank on an overlap-save bank)
MODES_KERNELS = ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os")


# ---------------------------------------------------------------------------
# phase K: the Case1 path on automatic picks (H2's files and cluster)
# ---------------------------------------------------------------------------

# the Case1 path's kernels: the batched scan and the re-verify and FAS
PICKS_KERNELS = ("fwd_prep_fold", "spec_ds_fold") + DENSE_KERNELS


def k1_auto_phases(h2, tmpdir):
    """K1: util.autoPickPhases over H2's event directory (every station /
    event stream, cut as H2's directories cut them, bandpassed [1, 10, 2,
    true], STA/LTA 0.5 / 5 s, threshold 3); its picks against H2's
    PhasePicks.csv, printed and not gated; the file read back by
    attachPickTimes on a fresh SubSpace of H2's cluster, where every
    subspace and single with a picked event must get its trims."""
    from detex_torch.data import keys
    paths = h2["paths"]
    out = os.path.join(tmpdir, "AutoPhasePicks.csv")
    d = H2_PARAMS["directories"]
    t0 = time.perf_counter()
    rows = util.autoPickPhases(
        templateKey=paths["templateKey"], stationKey=paths["stationKey"],
        fetch=paths["eventDir"], fileName=out, tb4=d["tb4"], taft=d["taft"])
    secs = time.perf_counter() - t0
    truth = {(r["Station"], r["Event"]): r["TimeStamp"]
             for r in keys.read_csv(paths["phaseKey"])[1]}
    errs = np.array([abs(r["TimeStamp"] - truth[(r["Station"], r["Event"])])
                     for r in rows if (r["Station"], r["Event"]) in truth])
    need(len(errs) > 0, "phase K1: no automatic pick matches a pick of "
         "H2's phase file")
    ss = detex_torch.createSubSpace(clust=h2["clust"], dtype="single",
                                    conDatFetcher=h2["cfetcher"],
                                    **H2_PARAMS["createSubSpace"])
    ss.attachPickTimes(pksFile=out, **H2_PARAMS["attachPickTimes"])
    picked = {(r["Station"], r["Event"]) for r in rows}
    bare = [(sta, r["Name"]) for frames in (ss.subspaces, ss.singles)
            for sta, rs in frames.items() for r in rs
            if not r["SampleTrims"]
            and any((sta, e) in picked for e in r["Events"])]
    need(not bare, "phase K1: attachPickTimes gave no trims to %s from "
         "the automatic picks" % bare)
    n_rows = sum(len(rs) for frames in (ss.subspaces, ss.singles)
                 for rs in frames.values())
    say("phase K1: autoPickPhases %.3f s: %d picks of %d station / event "
        "streams; |auto - H2's picks| median %.3f s, largest %.3f s; "
        "attachPickTimes trimmed %d of %d detectors from the file"
        % (secs, len(rows), len(truth), float(np.median(errs)),
           float(errs.max()), n_rows - len(bare), n_rows))
    return dict(picks=len(rows), streams=len(truth),
                median_s=float(np.median(errs)), max_s=float(errs.max()),
                seconds=secs)


def hidden_verified(vers, hidden):
    """The hidden origin times that a verified window brackets within 10 s
    (case1_verified's rule)."""
    return sorted(t for t in hidden
                  if any(v["MSTAMPmin"] - 10 <= t <= v["MSTAMPmax"] + 10
                         for v in vers))


def k_trims(ss):
    """{"sta name": [Starttime, Endtime]} of every detector of ``ss``."""
    return {"%s %s" % (sta, r["Name"]): [r["SampleTrims"].get("Starttime"),
                                         r["SampleTrims"].get("Endtime")]
            for frames in (ss.subspaces, ss.singles)
            for sta, rs in frames.items() for r in rs}


def k2_auto_trims(h2, tmpdir):
    """K2: createSubSpace from H2's cluster -> autoPickTimes(duration=30)
    in place of attachPickTimes -> SVD with FAS at H2's settings -> detex
    over all of H2's station-hours -> detResults. Gates: every hidden
    event H2 verified is verified again (a miss prints its rows and the
    trims autoPickTimes chose, then fails), and the verified rows' DS
    within 2e-5 of the float64 oracle."""
    from detex_torch import results
    p, paths, cf = H2_PARAMS, h2["paths"], h2["cfetcher"]
    stages = {}

    def stage(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    ss = stage("subspace", detex_torch.createSubSpace, clust=h2["clust"],
               dtype="single", conDatFetcher=cf, **p["createSubSpace"])
    stage("autopick", ss.autoPickTimes, duration=30)
    with Clock((fas, "_initFAS")) as fc:
        stage("svd", ss.SVD, **p["SVD"])
    stages["fas"] = fc.seconds["_initFAS"]
    stages["svd"] -= stages["fas"]
    workdir = os.path.join(tmpdir, "k2")
    os.makedirs(workdir, exist_ok=True)
    db = os.path.join(workdir, "SubSpace.db")
    stage("detex", ss.detex, subspaceDB=db, **p["detex"])
    res = stage("results", results.detResults, ssDB=db,
                templateKey=paths["templateKey"],
                stationKey=paths["stationKey"], veriFile=paths["veriFile"],
                fetch=cf, **p["detResults"])
    hidden = [e["time"] for e in h2["cat"].hidden]
    want = hidden_verified(h2["res"].Vers, hidden)
    got = hidden_verified(res.Vers, hidden)
    say("phase K2: trims (multiplexed samples) from autoPickTimes %s; "
        "from H2's phase file %s" % (json.dumps(k_trims(ss)),
                                     json.dumps(k_trims(h2["ss"]))))
    missed = sorted(set(want) - set(got))
    for t in missed:
        near = [(str(r["Sta"]), str(r["Name"]), float(r["STMP"]),
                 float(r["DS"])) for table in ("ss_df", "sg_df")
                for r in util.loadSQLite(db, table) or []
                if abs(r["STMP"] - t) < 60]
        say("phase K2: hidden event at %.3f not verified; rows within 60 s: "
            "%s" % (t, near))
    need(not missed, "phase K2: hidden events %s verified on H2's picks "
         "were not verified on automatic trims" % missed)
    n_rows, err = h2_oracle(dict(ss=ss, cfetcher=cf, res=res), "single",
                            tag="K2")
    n_hours = p["synth"]["n_stations"] * p["synth"]["span_hours"]
    rate = n_hours / stages["detex"]
    h2_rate = n_hours / h2["detex_s"]
    say("phase K2: %s: stages (s) %s; %d of %d hidden events verified (H2: "
        "%d); %d verified rows vs float64 oracle DS err %.3g; detex %.3f "
        "station-hours/s (H2 on its picks: %.3f)"
        % (card_line(), json.dumps({k: round(v, 3) for k, v in
                                    stages.items()}),
           len(got), len(hidden), len(want), n_rows, err, rate, h2_rate))
    return dict(stages=stages, verified=len(got), oracle_err=err,
                station_hours_per_s=rate, h2_station_hours_per_s=h2_rate)


def phase_k(dev, h2, tmpdir):
    """Phase K: K1 automatic phase picks, K2 the Case1 path on automatic
    trims, on H2's files and cluster (``h2`` phase_h2's result)."""
    h2 = dict(h2["objs"], detex_s=h2["stages"]["detex"])
    t0 = time.perf_counter()
    out = dict(k1=k1_auto_phases(h2, tmpdir), k2=k2_auto_trims(h2, tmpdir))
    out["wall"] = time.perf_counter() - t0
    say("phase K: %.1f s with its checks (%s)" % (out["wall"], card_line()))
    return out


# the phases that run on H2's objects: their function and the kernels
# their path must launch
ON_H2 = {"J": (phase_j, MODES_KERNELS), "K": (phase_k, PICKS_KERNELS)}


def run_on_h2(phase, dev, h2, tmpdir, counted, launches):
    """Phase J or K counted, with the first launch of every kernel
    captured and held against its twin; the kernels of its path must have
    run."""
    fn, kernels = ON_H2[phase]
    with KernelCapture() as cap:
        counted(phase, fn, dev, h2, tmpdir)
    held = hold_captured(phase, cap)
    say("phase %s launches %s" % (phase, {
        k: v for k, v in launches[phase].items() if v}))
    for k in kernels:
        need(launches[phase][k] > 0 and k in held, "kernel %s did not run, "
             "or was not held, in phase %s" % (k, phase))
    return held


def main_after_h2(dev, phase):
    """``--phases J`` or ``--phases K``: the kernels built, phase H2 (the
    phase's SubSpace, cluster and hour files), then the phase with its
    holds; the launches of H2 and the phase."""
    launches = {}

    def counted(tag, fn, *args):
        ck.reset_launches()
        tscan.ROUTE_COUNTS.clear()
        out = fn(*args)
        launches[tag] = dict(ck.LAUNCHES)
        return out

    tmp = tempfile.TemporaryDirectory()
    h2 = counted("H2", phase_h2, dev, os.path.join(tmp.name, "h2"))
    held = run_on_h2(phase, dev, h2, tmp.name, counted, launches)
    tmp.cleanup()
    say(json.dumps({"launches": {p: {k: v for k, v in ls.items() if v}
                                 for p, ls in launches.items()},
                    "phase_%s_holds" % phase.lower(): {
                        k: v["err"] for k, v in held.items()}}))


def main_phase_i(dev):
    """``--phases I``: the kernels built, phase H2 (phase I's SubSpace and
    hour files), phase I and the kernels held off cuda:0; the launches of
    H2 and I, the card's line and the ok line."""
    launches = {}
    tmp = tempfile.TemporaryDirectory()
    for phase, fn, args in (
            ("H2", phase_h2, (dev, os.path.join(tmp.name, "h2"))),
            ("I", None, None)):
        ck.reset_launches()
        tscan.ROUTE_COUNTS.clear()
        if fn is not None:
            h2 = fn(*args)
        else:
            pi = phase_i(dev, h2["objs"], tmp.name)
        launches[phase] = {k: v for k, v in ck.LAUNCHES.items() if v}
    tmp.cleanup()
    for k in ("fwd_prep_fold", "spec_ds_fold") + DENSE_KERNELS:
        need(launches["I"].get(k, 0) > 0, "kernel %s did not run in phase I"
             % k)
    if torch.cuda.device_count() > 1:
        hold_off_device(torch.device("cuda", torch.cuda.device_count() - 1))
    say(json.dumps({"launches": launches, "phase_i": {
        "mesh_size": pi["mesh_size"],
        "phase_a_station_days_per_s": dict(zip(
            ("sharded", "unsharded"), pi["a"]["rates"]["device"])),
        "phase_a_host_station_days_per_s": dict(zip(
            ("sharded", "unsharded"), pi["a"]["rates"]["host"])),
        "engine_s": dict(zip(("mesh", "single"), pi["engine_s"])),
        "mseed_mb_s": pi["mseed"]}}))


def main():
    import sys
    args = sys.argv[1:]
    if args and (len(args) != 2 or args[0] != "--phases"
                 or args[1] not in ("I", "J", "K")):
        raise SystemExit("usage: chip_smoke.py [--phases I|J|K]")
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
    t0 = time.perf_counter()
    need(native.available(), "the native host library did not build")
    say("native host library: %.1f s (%s)" % (time.perf_counter() - t0,
                                              native.library_path()))
    if args:
        if args[1] == "I":
            main_phase_i(dev)
        else:
            main_after_h2(dev, args[1])
        say(card_line())
        say(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

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
    say("phase 2: the scan kernels at one block of work and under one wave")
    checks.append(scan_extras(dev))
    torch.cuda.empty_cache()

    launches, routes = {}, {}

    def counted(phase, fn, *args):
        ck.reset_launches()
        tscan.ROUTE_COUNTS.clear()
        out = fn(*args)
        launches[phase] = dict(ck.LAUNCHES)
        routes[phase] = dict(tscan.ROUTE_COUNTS)
        return out

    def check_phases(want):
        for phase, ks, rs in want:
            say("phase %s launches %s; routes %s" % (
                phase, {k: v for k, v in launches[phase].items() if v},
                routes[phase]))
            for k in ks:
                need(launches[phase][k] > 0,
                     "kernel %s did not run on phase %s" % (k, phase))
            for r in rs:
                need(routes[phase].get(r, 0) > 0,
                     "phase %s did not take route %s: %s"
                     % (phase, r, routes[phase]))

    tmp = tempfile.TemporaryDirectory()
    pa = counted("A", phase_a, dev)
    counted("B", phase_b, dev, tmp.name)
    pc = counted("C", phase_c, dev, pa["station_days_per_s"])
    fused = ("fwd_prep_fold", "spec_ds_fold")
    check_phases((("A", fused, ("fused-sub+fusedprep",)),
                  ("B", fused, ("fused-net+fusedprep",)),
                  ("C", fused + DENSE_KERNELS, ("fused-sub+fusedprep",))))
    times = anatomy(dev, pa)
    times.update(dense_anatomy(dev, pc))
    del pa, pc
    torch.cuda.empty_cache()

    say("phase D: per-chunk routes and the unfused prep; B6-B9 vs twins at "
        "phase D's shapes")
    d1 = serving_setup(dev, tmp.name, "d1", 128, 32, 60.0, 8,
                       amp=3.0 * np.sqrt(60 * SR * NC))
    d2 = serving_setup(dev, tmp.name, "d2", 128, 64, 30.0, 9)
    d3 = phase_d3_setup(dev)
    res_d = phase_d_kernels(dev, d1, d2, d3)
    checks.append(res_d)
    times.update(res_d)
    say("phase D: the forward transforms at small N, at n = 32768 and in "
        "the framed form")
    checks.append(forward_extras(dev))
    say("phase D: the inverse transform at the per-chunk shapes, one row "
        "and under one wave")
    checks.append(inverse_extras(dev))
    torch.cuda.empty_cache()
    counted("D1", phase_d1, dev, d1)
    del d1
    counted("D2", serve_and_check, "D2", d2)
    del d2
    counted("D3", phase_d3, dev, d3)
    del d3
    counted("D4", phase_d4, dev)
    tmp.cleanup()
    check_phases((
        ("D1", ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os",
                "hist_uniform"), ("plain",)),
        ("D2", ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os_scan"),
         ("plain",)),
        ("D3", ("rfft_ct_half", "spec_ds_fold"), ("fused-sub",)),
        ("D4", ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os_scan",
                "ds_finalize_os_fold"), ("plain", "fold"))))
    torch.cuda.empty_cache()

    say("phase E: device prep, full-length and multiplexed banks; "
        "ds_finalize vs twin at E2's shape")
    tmp = tempfile.TemporaryDirectory()
    e1 = phase_e1_setup(dev, tmp.name)
    e2 = phase_e2_setup(dev)
    e3 = phase_e3_setup(dev)
    res_e = phase_e_kernels(dev, e2)
    checks.append(res_e)
    times.update(res_e)
    torch.cuda.empty_cache()
    counted("E1", phase_e1, e1)
    del e1
    counted("E2", phase_e2, dev, e2)
    del e2
    counted("E3", phase_e3, dev, e3)
    del e3
    counted("E4", phase_e4, dev)
    tmp.cleanup()
    check_phases((
        ("E1", fused, ("fused-net+fusedprep+devicePrep",)),
        ("E2", ("ds_finalize", "hist_uniform"), ("plain",)),
        ("E3", ("ds_finalize", "hist_uniform"), ("raw-demux+devicePrep",)),
        ("E4", ("ds_finalize",), ("plain", "raw-demux+devicePrep"))))
    torch.cuda.empty_cache()

    say("phase F: the detection engine (detect.detex) on the card")
    tmp = tempfile.TemporaryDirectory()
    counted("F1", phase_f1, dev, tmp.name)
    f2 = counted("F2", phase_f2, dev, tmp.name)
    phase_f2_blocks(dev, f2)
    del f2
    torch.cuda.empty_cache()
    f3 = counted("F3", phase_f3, dev, tmp.name)
    phase_f3_host(dev, tmp.name, f3)
    tmp.cleanup()
    check_phases((
        ("F1", fused + DENSE_KERNELS, ("fused-net+fusedprep",
                                       "dense-reverify-device")),
        ("F2", fused + ("rfft_ct_fused", "irfft_ct_fused", "ds_finalize_os"),
         ("blocked-fused-net+fusedprep", "dense-reverify-device")),
        ("F3", fused + DENSE_KERNELS, ("fused-net+fusedprep+devicePrep",
                                       "dense-reverify-device"))))

    say("phase G: detector construction (construct, subspace, fas) on the "
        "card")
    g = dict(zip(("events", "waves"), g_catalog()))
    g.update(zip(("streams", "templates", "picks"),
                 g_templates(g["events"], g["waves"])))
    tmp = tempfile.TemporaryDirectory()
    counted("G1", phase_g1, dev, g)
    g2 = counted("G2", phase_g2, dev, g, tmp.name)
    tmp.cleanup()
    del g
    check_phases((("G2", fused + DENSE_KERNELS, ("fused-net+fusedprep",
                                                 "dense-reverify-device")),))
    say("phase G2 FAS launches %s" % {k: v for k, v in
                                      g2["fas_launches"].items() if v})
    for k in DENSE_KERNELS:
        need(g2["fas_launches"][k] > 0, "kernel %s did not run in FAS" % k)

    say("phase H: the Case1 pipeline from key files and indexed npz "
        "directories (data layer, construction, detex, detResults)")
    with open(CASE1_FIXTURE) as fh:
        fixture = json.load(fh)
    tmp = tempfile.TemporaryDirectory()
    for dtype in ("double", "single"):
        with KernelCapture() as cap:
            rec, objs, stages = counted(
                "H1-" + dtype, case1_run, fixture["params"], dtype,
                os.path.join(tmp.name, dtype), dev)
        th_err, ds_err, ties = case1_hold("H1 " + dtype, rec,
                                          fixture[dtype], objs)
        say("phase H1 %s: Case1 against detex_tpu's record: clusters, "
            "delays, NumBasis, rows and STMP identical (%d near-tie lags); "
            "thresholds rel err %.3g, DS err %.3g; %d of %d hidden events "
            "verified; stages (s) %s"
            % (dtype, ties, th_err, ds_err, len(rec["results"]["Vers"]),
               len(rec["hidden"]),
               json.dumps({k: round(v, 3) for k, v in stages.items()})))
        checks.append(hold_captured("H1 " + dtype, cap))
        del objs, cap
    with KernelCapture() as cap:
        h2 = counted("H2", phase_h2, dev, os.path.join(tmp.name, "h2"))
    checks.append(hold_captured("H2", cap))
    del cap
    h_phases = ("H1-double", "H1-single", "H2")
    h_launches = {k: sum(launches[p][k] for p in h_phases)
                  for k in KERNEL_INFO}
    say("phase H launches %s" % {k: v for k, v in h_launches.items() if v})
    for k in fused + DENSE_KERNELS:
        need(h_launches[k] > 0, "kernel %s did not run in phase H" % k)
    torch.cuda.empty_cache()

    say("phase I: several devices, the serving artifact's writer and "
        "miniSEED")
    counted("I", phase_i, dev, h2["objs"], tmp.name)
    say("phase I launches %s" % {k: v for k, v in launches["I"].items()
                                 if v})
    for k in fused + DENSE_KERNELS:
        need(launches["I"][k] > 0, "kernel %s did not run in phase I" % k)
    if torch.cuda.device_count() > 1:
        hold_off_device(torch.device("cuda", torch.cuda.device_count() - 1))
    torch.cuda.empty_cache()

    say("phase J: the engine's classify and UTC-save modes on the per-chunk "
        "path, saved objects, quality_check")
    checks.append(run_on_h2("J", dev, h2, tmp.name, counted, launches))
    torch.cuda.empty_cache()

    say("phase K: the Case1 path on automatic picks (autoPickPhases, "
        "autoPickTimes) at H2's full width")
    checks.append(run_on_h2("K", dev, h2, tmp.name, counted, launches))
    tmp.cleanup()
    del h2

    # ms / plain_ms / library_ms / bound_ms: kernel, twin and the PyTorch
    # call computing the same function, at phase A's full shape (scan
    # kernels), at phase C's re-verify shape (dense kernels), at phase D's
    # shapes (per-chunk kernels and rfft_ct_half) and at phase E2's
    # (ds_finalize); launches: every counted phase, A-J; engine_launches:
    # the engine's own, phases F1-F3; construct_launches: G1-G2;
    # pipeline_launches: the key-file pipeline, H1-H2; mesh_launches:
    # phase I; modes_launches: the classify and UTC-save modes and the
    # per-chunk path, phase J; picks_launches: Case1 on automatic picks,
    # phase K
    kernels = []
    for k, (src, replaces) in KERNEL_INFO.items():
        bound_ms, bound_by = times[k]["bound"]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=sum(launches[p][k] for p in launches),
            engine_launches=sum(launches[p][k] for p in ("F1", "F2", "F3")),
            construct_launches=sum(launches[p][k] for p in ("G1", "G2")),
            pipeline_launches=h_launches[k],
            mesh_launches=launches["I"][k],
            modes_launches=launches["J"][k],
            picks_launches=launches["K"][k],
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
