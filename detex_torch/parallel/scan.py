"""
Batched continuous-data scan over a bank of any form.

Namesake of detex_tpu/parallel/scan.py. scan_chunks takes
detex_tpu's route (_os_fold_route), in its order, on an overlap-save bank:

  fused    one spec_ds_fold launch over the whole chunk batch, prepped by
           fwd_prep_fold ("fused-net+fusedprep", "fused-sub+fusedprep") or,
           where that kernel refuses the geometry (n_c > W), by
           os_prep_batch_pair with rfft_ct_half ("fused-net", "fused-sub");
  fold     the unfused batch: os_prep_batch + os_block_scan_batch (block
           transforms, then ds_finalize_os_fold with the histogram);
  blocked  past TEMPLATE_BLOCK templates: the batch's prep once, then a
           loop over blocks of TEMPLATE_BLOCK templates, each one
           spec_ds_fold launch in mode "net" ("blocked-fused-net",
           "+fusedprep" behind fwd_prep_fold) or one os_block_scan_batch
           ("blocked-fold"); the bank's arrays are padded to whole blocks
           (zero templates, +inf thresholds) and the outputs cut back to S;
  plain    one chunk at a time (_chunk_fn): os_prep + os_block_scan
           (ds_finalize_os_scan, or ds_finalize_os and hist_uniform where the
           block is too wide for the scan form), non-uniform bins by sort and
           search; past TEMPLATE_BLOCK templates a loop over the blocks.

A full-length demuxed or multiplexed bank always takes "plain": one chunk
at a time, ds_bank_demux (kernel ds_finalize) or ds_bank, the pad mask,
_hist_rows, and trigger extraction by extract_triggers_pyramid (rows of at
least PYRAMID_MIN_LEN) or extract_triggers_topk, in blocks of
TEMPLATE_BLOCK templates past that many.

scan_chunks_raw scans raw channel chunks with the device prep
(ops/prep.py): on an overlap-save bank prep_multiplex_batch and then
scan_chunks (route name + "+devicePrep"); on a full-length demuxed bank
route "raw-demux+devicePrep", one ds_bank_demux_raw per chunk and block
of TEMPLATE_BLOCK templates (any S).

The caps that send a batch down the list are detex_tpu's (ops/ds.py
FUSED_DS_BYTES, FOLD_CB_BYTES); its Pallas tile budgets have no
counterpart here (ROADMAP C20).

With a mesh of more than one entry (parallel/mesh.py) scan_chunks and
scan_chunks_raw hand off to scan_chunks_sharded / scan_chunks_raw_sharded:
the batch is padded to a multiple of the mesh size with zero-length
chunks (_pad_batch), each entry scans its run of rows on its device
against its copy of the bank, by the route _os_fold_route picks for the
per-shard batch (names + "+sharded"), and the histograms are summed on the
mesh's first device while the maxima and triggers are joined in shard
order. engine_mesh is the mesh the engine shards over: every CUDA device
when there are several (DETEX_TORCH_MESH=0 turns it off).
"""
from __future__ import annotations

import os
import threading
from collections import Counter

import numpy as np
import torch

import detex_torch
from detex_torch import trace as _trace
from detex_torch.kernels import build as _build
from detex_torch.ops import cuda_kernels as _ck
from detex_torch.ops import ds as _ds
from detex_torch.ops import prep as _prep
from detex_torch.ops import triggers as _triggers
from detex_torch.parallel import mesh as _pmesh

DEFAULT_BINS = np.linspace(0, 1, 401)

# templates per block of the template-blocked routes (the batch route
# "blocked", the per-chunk route and the raw-demux route past this many)
TEMPLATE_BLOCK = 128

# Kernel-route observability: every scan records the route it dispatched
# in this counter (trace.counters() reports it as "routes.<route>") and
# logs each new route once.
ROUTE_COUNTS = _trace.counter_group("routes", Counter())
_ROUTES_LOGGED = set()


def route_name(route, mode):
    """Readable kernel route from _os_fold_route's (route, mode), as
    detex_tpu names it."""
    fp = "+fusedprep" if (mode or "").endswith("+fp") else ""
    mode = (mode or "")[:3]
    if route == "fold":
        return {"net": "fused-net", "sub": "fused-sub"}.get(mode,
                                                            "fold") + fp
    if route == "blocked":
        return ("blocked-fused-net" if mode == "net"
                else "blocked-fold") + fp
    return "plain"


def _note_route(name, device_prep=False, sharded=False):
    """Count, and log once per unique name, the route a scan dispatched;
    ``sharded`` appends "+sharded" and ``device_prep`` "+devicePrep", as
    detex_tpu does."""
    if sharded:
        name += "+sharded"
    if device_prep:
        name += "+devicePrep"
    _trace.count(name, counts=ROUTE_COUNTS)
    if name not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add(name)
        detex_torch.log(__name__, "scan kernel route: %s" % name)
    return name


def engine_mesh(device=None):
    """The mesh the detection engine shards its chunk batches over: every
    CUDA device of the host when there is more than one and ``device``
    (the engine's) is a CUDA device, else None (one device). The
    environment variable DETEX_TORCH_MESH=0 turns it off."""
    if os.environ.get("DETEX_TORCH_MESH", "1") == "0":
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    if torch.cuda.device_count() < 2:
        return None
    return _pmesh.make_mesh()


def _pad_batch(n_dev, X, nv):
    """Round the chunk batch X (numpy or a tensor) up to a multiple of the
    mesh size with zero-length, fully masked chunks: zero rows and 0 in
    ``nv`` (valid lengths, numpy). Returns (Xp, nvp, B_orig)."""
    B = X.shape[0]
    Bp = -(-B // n_dev) * n_dev
    if Bp == B:
        return X, nv, B
    if isinstance(X, torch.Tensor):
        Xp = torch.cat([X, X.new_zeros((Bp - B,) + tuple(X.shape[1:]))])
    else:
        Xp = np.zeros((Bp,) + X.shape[1:], X.dtype)
        Xp[:B] = X
    nvp = np.zeros(Bp, nv.dtype)
    nvp[:B] = nv
    return Xp, nvp, B


def _run_shards(mesh, B, body):
    """body(i, r0, r1) for every mesh entry i over its rows [r0, r1) of a
    batch of B chunks; the results in mesh order. The entries of one
    device run in order in one host thread, one thread for each distinct
    CUDA device, so that every card is handed its work while another
    card's host work (its upload, a trigger loop that waits on it) is
    under way; entries on the CPU or on a single card run in the calling
    thread."""
    ranges = _pmesh.shard_chunks(mesh, B)
    groups = {}
    for i, dev in enumerate(mesh):
        groups.setdefault(dev, []).append(i)

    def run(idx):
        return [(i, body(i, *ranges[i])) for i in idx]

    if sum(d.type == "cuda" for d in groups) < 2:
        with _trace.span("scan"):
            pairs = run(range(len(mesh)))
    else:
        _build.load_library()        # built once, before the threads
        results = {}

        def work(key, idx):
            try:
                with _trace.span("scan"):
                    results[key] = run(idx)
            except BaseException as e:   # re-raised in the calling thread
                results[key] = e

        threads = [threading.Thread(target=work, args=(k, g))
                   for k, g in enumerate(groups.values())]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        pairs = []
        for k in range(len(threads)):
            if isinstance(results[k], BaseException):
                raise results[k]
            pairs += results[k]
    out = [None] * len(mesh)
    for i, r in pairs:
        out[i] = r
    return out


def _gather(mesh, outs, B):
    """The shards' (hist, maxds, tidx, tval, tcnt) as one result on the
    mesh's first device: the histograms summed (exact in int32), the rest
    joined in shard order and cut back to the B real chunks."""
    dev = mesh[0]
    hist = outs[0][0].to(dev)
    for o in outs[1:]:
        hist = hist + o[0].to(dev)
    return (hist,) + tuple(torch.cat([o[k].to(dev) for o in outs])[:B]
                           for k in range(1, 5))


def _uniform_nbin(bins):
    """nbin if ``bins`` are the uniform [0, 1] edges the fused histogram
    supports (perfect-square bin count, as detex_tpu requires), else 0."""
    b = np.asarray(bins)
    n = len(b) - 1
    g = int(round(n ** 0.5))
    if g * g != n:
        return 0
    if not np.allclose(b, np.linspace(0.0, 1.0, n + 1), atol=1e-9):
        return 0
    return n


def _hist_counts(ds, bins):
    """np.histogram counts of every row of ds [S, L] in edges ``bins``
    (float32 tensor): sort + edge search, the last edge inclusive. int32
    [S, len(bins) - 1]."""
    s, _ = torch.sort(ds, dim=-1)
    R = s.shape[0]
    lo = torch.searchsorted(s, bins[:-1].expand(R, -1).contiguous(),
                            side="left")
    hi = torch.searchsorted(s, bins[-1:].expand(R, -1).contiguous(),
                            side="right")
    return torch.diff(torch.cat([lo, hi], dim=1), dim=1).to(torch.int32)


def _hist_rows(ds, bins, uniform_nbin):
    """Per-row histogram of ds [S, L]: the hist_uniform kernel (floor
    rule) for uniform bins, else _hist_counts."""
    if uniform_nbin:
        return _ck.hist_uniform(ds.contiguous(), uniform_nbin)
    return _hist_counts(ds, bins)


def _bank_statics(bank, nc):
    """detex_tpu's statics of a bank: demux "os", True (full-length) or
    False (multiplexed), the template length n_c (per channel; n for the
    multiplexed form) and the transform length nfft."""
    _, demux, n, nfft = _ds.BANK_FORMS[_ds.bank_kind(bank)]
    return dict(demux=demux, n_c=bank[n], nc=int(nc), nfft=bank[nfft],
                S=int(bank["sum_u"].shape[0]))


# from this DS row length on, the full-length route extracts triggers by
# the block-max pyramid (same outputs as the full-row form)
PYRAMID_MIN_LEN = 4096


def _extract(v, th, buff_samps, max_trig):
    """Triggers of rows v [R, L] at thresholds th [R] on the full-length
    route: (idx [R, max_trig] int32, count [R] int32)."""
    if v.shape[1] >= PYRAMID_MIN_LEN:
        return _triggers.extract_triggers_pyramid(v, th, buff_samps,
                                                  max_triggers=max_trig)
    return _triggers.extract_triggers_topk(v, th, buff_samps,
                                           max_triggers=max_trig)


def _blocks(a, axis):
    """``a`` zero-padded along ``axis`` to whole blocks of TEMPLATE_BLOCK
    and split there: [nB, ...] with the block's TEMPLATE_BLOCK rows at
    ``axis`` of each block (a contiguous view per block)."""
    SB = TEMPLATE_BLOCK
    S = a.shape[axis]
    Sp = -(-S // SB) * SB
    pad = list(a.shape)
    pad[axis] = Sp - S
    a = torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)],
                  dim=axis)
    a = a.reshape(a.shape[:axis] + (Sp // SB, SB) + a.shape[axis + 1:])
    return a.movedim(axis, 0).contiguous()


def _bank_arrays(bank):
    """The bank's (Ufd2 or Ufd, sum_u, d_mask); past TEMPLATE_BLOCK
    templates padded and split into blocks [nB, TEMPLATE_BLOCK, ...]
    (zero templates, masked slots), cached on the bank as detex_tpu
    caches them (scan.py:149-166)."""
    raw = (bank["Ufd2" if bank.get("demux") else "Ufd"], bank["sum_u"],
           bank["d_mask"])
    if raw[1].shape[0] <= TEMPLATE_BLOCK:
        return raw
    if "_blocked_arrs" not in bank:
        bank["_blocked_arrs"] = tuple(_blocks(a, 0) for a in raw)
    return bank["_blocked_arrs"]


def _specds_arrs(bank, blocked):
    """(ur, ui, sum_u, d_mask) of the fused spec -> DS kernel (ur / ui
    [Dmax, S, nc, Rp] from ds.bank_spec_pair). ``blocked`` pads and
    splits the template axis (axis 1 of ur / ui, axis 0 of sum_u /
    d_mask) into blocks of TEMPLATE_BLOCK: [nB, Dmax, SB, nc, Rp] and
    [nB, SB, Dmax], cached on the bank."""
    ur, ui = _ds.bank_spec_pair(bank)
    raw = (ur, ui, bank["sum_u"], bank["d_mask"])
    if not blocked:
        return raw
    if "_specds_blocked" not in bank:
        bank["_specds_blocked"] = (_blocks(ur, 1), _blocks(ui, 1),
                                   _blocks(raw[2], 0), _blocks(raw[3], 0))
    return bank["_specds_blocked"]


def _blocked_thresholds(thresholds, device):
    """Thresholds as a float32 tensor shaped to match _bank_arrays'
    blocking: [nB, TEMPLATE_BLOCK] with +inf in the pad slots past
    TEMPLATE_BLOCK templates, else flat [S]."""
    th = np.asarray(thresholds, np.float32)
    S = len(th)
    if S > TEMPLATE_BLOCK:
        SB = TEMPLATE_BLOCK
        th = np.concatenate([th, np.full(-(-S // SB) * SB - S, np.inf,
                                         np.float32)]).reshape(-1, SB)
    return torch.as_tensor(th, device=device)


def _valid_lens(bank, nc, X, valid_lens):
    """Per-chunk count of valid DS samples (windows fully inside real
    data)."""
    n = bank["n"]
    if valid_lens is None:
        valid_lens = [X.shape[1]] * X.shape[0]
    return np.asarray([(int(v) - n) // nc + 1 for v in valid_lens],
                      np.int32)


def _fold_scan_ok(bank, st, B, L_c, unb):
    """detex_tpu's tests for the batch routes on an overlap-save bank with
    uniform bins (scan.py:351-373, and :475-494 past TEMPLATE_BLOCK
    templates, for one block of TEMPLATE_BLOCK): the fused kernel's
    geometry with its DS array under FUSED_DS_BYTES, or the unfused
    batch's with its inverse blocks under FOLD_CB_BYTES."""
    if st["demux"] != "os" or not unb:   # hist width from uniform bins
        return False
    S = min(st["S"], TEMPLATE_BLOCK)
    Dmax = int(bank["Dmax"])
    _, _, _, W, m = _ds._os_geometry(L_c, st["n_c"], st["nfft"])
    if _ds.spec_ds_mode(B, S, Dmax, st["n_c"], st["nc"], st["nfft"]):
        return B * S * m * W * 4 <= _ds.FUSED_DS_BYTES
    if B * S * Dmax * m * st["nfft"] * 4 > _ds.FOLD_CB_BYTES:
        return False
    return _ds.fold_scan_supported(st["n_c"], st["nfft"])


def _os_fold_route(bank, st, B, L_c, unb, thresholds):
    """Kernel routing (detex_tpu scan.py:619-656). Returns (route, mode,
    arrs, thresholds_dev):

      "fold"     mode "net" / "sub" (+"+fp" with the fused prep) and arrs
                 (ur, ui, sum_u, d_mask) for the fused kernel, or mode None
                 and arrs (Ufd2, sum_u, d_mask) for the unfused batch;
      "blocked"  past TEMPLATE_BLOCK templates, the same per block of
                 TEMPLATE_BLOCK (mode "net": a block's rows are always
                 (chunk, template)), blocked arrs and [nB, TEMPLATE_BLOCK]
                 thresholds;
      None       the per-chunk loop with _bank_arrays.

    Full-length and multiplexed banks fall straight through to None."""
    th = _blocked_thresholds(thresholds, bank["sum_u"].device)
    if not _fold_scan_ok(bank, st, B, L_c, unb):
        return None, None, _bank_arrays(bank), th
    blocked = st["S"] > TEMPLATE_BLOCK
    mode = _ds.spec_ds_mode(B, min(st["S"], TEMPLATE_BLOCK),
                            int(bank["Dmax"]), st["n_c"], st["nc"],
                            st["nfft"])
    arrs = _specds_arrs(bank, blocked) if mode else _bank_arrays(bank)
    if mode and _ds.fwd_prep_ok(st["n_c"], st["nc"], st["nfft"]):
        mode += "+fp"
    return ("blocked" if blocked else "fold"), mode, arrs, th


def _no_trig(B, S, device):
    """Zero-capacity trigger outputs for calc_triggers=False."""
    return (torch.zeros((B, S, 0), dtype=torch.int32, device=device),
            torch.zeros((B, S, 0), dtype=torch.float32, device=device),
            torch.zeros((B, S), dtype=torch.int32, device=device))


def _triggers_of(dsf, pyrf, thf, buff_samps, max_trig):
    """Triggers of every row of dsf [R, L] from its block maxima pyrf:
    (idx [R, K] int32, values [R, K] with NaN where idx < 0, count [R])."""
    tidx, tcnt = _triggers.extract_triggers_pyramid_pm(
        dsf, pyrf, thf, buff_samps, max_triggers=max_trig)
    vals = torch.gather(dsf, 1, tidx.clamp(min=0).to(torch.int64))
    tval = torch.where(tidx >= 0, vals, torch.full_like(vals, float("nan")))
    return tidx, tval, tcnt


def _fold_chunks_fn(X, NV, arrs, thresholds, n_c, nc, blk_fft, buff_samps,
                    max_trig, S, calc_hist, uniform_nbin, specds_mode,
                    calc_triggers=True):
    """The batch routes over a chunk batch X [B, Lc]: (hist [S, nbin] int32
    summed over chunks, maxds [B, S], tidx [B, S, K] int32, tval [B, S, K],
    tcnt [B, S] int32). The prep runs once for the batch; then each block
    of templates (route "fold": the whole bank; route "blocked": the blocks
    of TEMPLATE_BLOCK of _specds_arrs(bank, True) or _bank_arrays, with
    thresholds [nB, SB], detex_tpu scan.py:497-574) takes one spec_ds_fold
    launch (``specds_mode`` "net" / "sub", "+fp" behind fwd_prep_fold) or
    one unfused os_block_scan_batch (``specds_mode`` None), and the blocks'
    summaries are joined along the template axis and cut to S.
    ``calc_triggers=False`` returns zero-capacity trigger outputs, and the
    fused kernel then runs summary-only (no DS array)."""
    B = X.shape[0]
    L_c = X.shape[1] // nc
    nbin = uniform_nbin if calc_hist else 0
    mode = (specds_mode or "")[:3]
    if mode:
        prep = (_ds.os_prep_batch_fused if specds_mode.endswith("+fp")
                else _ds.os_prep_batch_pair)
        Fr, Fi, a, power = prep(X, n_c, nc, blk_fft)
    else:
        F, a, power = _ds.os_prep_batch(X, n_c, nc, blk_fft)
    blocks = (zip(zip(*arrs), thresholds) if thresholds.dim() == 2
              else [(arrs, thresholds)])
    parts = []
    for blk, th in blocks:
        if mode:
            ds, pyr, hist = _ds.os_scan_batch_fused(
                Fr, Fi, a, power, *blk, mode, n_c, nc, blk_fft, L_c, NV,
                nbin=nbin, emit_ds=calc_triggers)
        else:
            ds, pyr, hist = _ds.os_block_scan_batch(
                F, a, power, *blk, n_c, nc, blk_fft, L_c, NV, nbin=nbin)
        parts.append(_block_summaries(ds, pyr, hist, th, B, mode == "sub",
                                      uniform_nbin, calc_hist, calc_triggers,
                                      buff_samps, max_trig))
        del ds, pyr, hist
    hist = torch.cat([p[0] for p in parts])[:S]
    maxds = torch.cat([p[1] for p in parts], dim=1)[:, :S]
    if not calc_triggers:
        return (hist, maxds) + _no_trig(B, S, X.device)
    return (hist, maxds) + tuple(torch.cat(t, dim=1)[:, :S]
                                 for t in zip(*[p[2] for p in parts]))


def _block_summaries(ds, pyr, hist, th, B, sub, uniform_nbin, calc_hist,
                     calc_triggers, buff_samps, max_trig):
    """One template block's (hist [SB, nbin] int32, maxds [B, SB], and
    (tidx, tval, tcnt) [B, SB, ...] or None) from a batch scan's rows:
    (chunk, template) rows, or (template, chunk) with ``sub`` (fused mode
    "sub"), of which only the summaries are transposed back, never the DS
    array."""
    SB = th.shape[0]
    if sub:
        thf = th[:, None].expand(SB, B).reshape(-1)

        def tr(x):
            return x.reshape((SB, B) + x.shape[1:]).transpose(0, 1)
    else:
        thf = th[None, :].expand(B, SB).reshape(-1)

        def tr(x):
            return x.reshape((B, SB) + x.shape[1:])
    pyrf = pyr.reshape(B * SB, -1)
    if calc_hist:
        h = tr(hist.reshape(B * SB, -1)).sum(dim=0).to(torch.int32)
    else:
        h = torch.zeros((SB, uniform_nbin), dtype=torch.int32,
                        device=pyr.device)
    trig = None
    if calc_triggers:
        trig = tuple(tr(t) for t in _triggers_of(
            ds.reshape(B * SB, -1), pyrf, thf, buff_samps, max_trig))
    return h, tr(pyrf.amax(dim=-1)), trig


def _finish(ds, nv, thresholds, bins, buff_samps, max_trig, calc_hist,
            uniform_nbin, calc_triggers):
    """The full-length route's summaries of one chunk's DS rows ds [S, L]
    (detex_tpu _chunk_fn's ``finish``): -inf at positions >= nv, the
    histogram, the maxima and the triggers (or None)."""
    pos = torch.arange(ds.shape[-1], device=ds.device)
    ds = torch.where(pos[None, :] < nv, ds, torch.full_like(ds, float("-inf")))
    if calc_hist:
        hist = _hist_rows(ds, bins, uniform_nbin)
    else:
        hist = torch.zeros((ds.shape[0], bins.shape[0] - 1),
                           dtype=torch.int32, device=ds.device)
    maxds = ds.amax(dim=-1)
    if not calc_triggers:
        return hist, maxds, None
    tidx, tcnt = _extract(ds, thresholds, buff_samps, max_trig)
    vals = torch.gather(ds, 1, tidx.clamp(min=0).to(torch.int64))
    tval = torch.where(tidx >= 0, vals, torch.full_like(vals, float("nan")))
    return hist, maxds, (tidx, tval, tcnt)


def _chunk_fn(x, nv, arrs, thresholds, bins, demux, n_c, nc, nfft,
              buff_samps, max_trig, S, calc_hist, uniform_nbin,
              calc_triggers):
    """One chunk of the per-chunk route (detex_tpu scan.py:258-348): x [Lc],
    nv its valid DS length (a 0-d int32 on the device). Returns
    (hist [S, nbins] int32, maxds [S], and (tidx [S, K], tval [S, K],
    tcnt [S]) or None without triggers); the chunk's DS array is freed on
    return. An overlap-save bank (demux "os") runs os_prep once and
    os_block_scan per template block, extracting triggers from the
    finalize's block maxima; the other forms run ds.ds_of and _finish.
    ``arrs`` pre-blocked by _bank_arrays ([nB, SB, ...], thresholds
    [nB, SB]) run block by block and are joined and cut to S."""
    if demux == "os":
        F, a, power = _ds.os_prep(x, n_c, nc, nfft)

        def run_one(blk_arrs, th):
            ds, pyr, fused_hist = _ds.os_block_scan(
                F, a, power, blk_arrs[0], blk_arrs[1], blk_arrs[2], n_c, nc,
                nfft, x.shape[0] // nc, nv,
                nbin=uniform_nbin if calc_hist else 0)
            if not calc_hist:
                hist = torch.zeros((ds.shape[0], bins.shape[0] - 1),
                                   dtype=torch.int32, device=x.device)
            elif fused_hist is not None:
                hist = fused_hist
            else:
                hist = _hist_rows(ds, bins, uniform_nbin)
            trig = (_triggers_of(ds, pyr, th, buff_samps, max_trig)
                    if calc_triggers else None)
            return hist, pyr.amax(dim=-1), trig
    else:
        def run_one(blk_arrs, th):
            return _finish(_ds.ds_of(x, blk_arrs, demux, n_c, nc, nfft), nv,
                           th, bins, buff_samps, max_trig, calc_hist,
                           uniform_nbin, calc_triggers)

    if arrs[2].dim() == 2:                  # d_mask [S, Dmax]: one block
        return run_one(arrs, thresholds)
    outs = [run_one(tuple(t[i] for t in arrs), thresholds[i])
            for i in range(thresholds.shape[0])]
    hist = torch.cat([o[0] for o in outs])[:S]
    maxds = torch.cat([o[1] for o in outs])[:S]
    if not calc_triggers:
        return hist, maxds, None
    return hist, maxds, tuple(torch.cat(parts)[:S]
                              for parts in zip(*[o[2] for o in outs]))


def _stack_chunks(outs, B, S, nbins, calc_triggers, dev):
    """Sum the per-chunk histograms and stack the maxima and triggers of
    a loop over B chunks: (hist [S, nbins], maxds [B, S], tidx, tval,
    tcnt [B, S, ...])."""
    hist = torch.zeros((S, nbins), dtype=torch.int32, device=dev)
    for h, _, _ in outs:
        hist += h
    maxds = (torch.stack([o[1] for o in outs]) if outs else
             torch.empty((0, S), dtype=torch.float32, device=dev))
    if not calc_triggers:
        return (hist, maxds) + _no_trig(B, S, dev)
    return (hist, maxds) + tuple(torch.stack(parts)
                                 for parts in zip(*[o[2] for o in outs]))


def _scan_chunks_loop(X, NV, arrs, thresholds, bins, demux, n_c, nc, nfft,
                      buff_samps, max_trig, S, calc_hist, uniform_nbin,
                      calc_triggers):
    """The per-chunk route over a chunk batch X [B, Lc] (detex_tpu
    _scan_chunks_jit's lax.map as a loop): hist summed over chunks,
    maxds [B, S], triggers stacked [B, S, K]. Adds no host sync of its own;
    the trigger loop syncs once per step as everywhere."""
    outs = [_chunk_fn(X[b], NV[b], arrs, thresholds, bins, demux, n_c, nc,
                      nfft, buff_samps, max_trig, S, calc_hist, uniform_nbin,
                      calc_triggers) for b in range(X.shape[0])]
    return _stack_chunks(outs, X.shape[0], S, bins.shape[0] - 1,
                         calc_triggers, X.device)


def _scan_rows(route, mode, arrs, th, X, NV, st, bins, buff_samps, max_trig,
               calc_hist, unb, calc_triggers):
    """A chunk batch X [B, Lc] with valid DS lengths NV on X's device,
    scanned by the route _os_fold_route picked (its route, mode, arrays
    and thresholds): scan_chunks' outputs on that device."""
    if route:
        return _fold_chunks_fn(
            X, NV, arrs, th, st["n_c"], st["nc"], st["nfft"],
            int(buff_samps), int(max_trig), st["S"], bool(calc_hist), unb,
            mode, calc_triggers=bool(calc_triggers))
    bins_t = torch.as_tensor(np.asarray(bins), dtype=torch.float32,
                             device=X.device)
    return _scan_chunks_loop(
        X, NV, arrs, th, bins_t, st["demux"], st["n_c"], st["nc"],
        st["nfft"], int(buff_samps), int(max_trig), st["S"],
        bool(calc_hist), unb, bool(calc_triggers))


def scan_chunks(X, bank, thresholds, nc, buff_samps, bins=None, max_trig=64,
                valid_lens=None, mesh=None, calc_hist=True,
                calc_triggers=True, _device_prep=False):
    """Batched scan: X [B, Lc] -> (hist [S, nbin], maxds [B, S],
    trig_idx [B, S, K], trig_val [B, S, K], trig_count [B, S]) as tensors
    on the bank's device, by the route _os_fold_route picks.

    ``valid_lens`` ([B], optional) gives each chunk's true multiplexed
    sample count when rows are zero-padded. ``calc_hist=False`` returns a
    zero histogram. ``calc_triggers=False`` (the engine's summary-only
    mode) skips trigger extraction: trigger outputs come back
    zero-capacity (and on the fused route the DS array is never written).
    Uniform [0, 1] bins count by the floor rule, other bins by
    np.histogram's rule. X may be a numpy array or a tensor; it is moved to
    the bank's device. With a ``mesh`` of more than one entry the batch is
    sharded across it (scan_chunks_sharded)."""
    if mesh is not None and mesh.size > 1:
        return scan_chunks_sharded(
            mesh, X, bank, thresholds, nc, buff_samps, bins=bins,
            max_trig=max_trig, valid_lens=valid_lens, calc_hist=calc_hist,
            calc_triggers=calc_triggers, _device_prep=_device_prep)
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    dev = bank["sum_u"].device
    X = _ds.to_device(X, dev)
    nv = _valid_lens(bank, nc, X, valid_lens)
    unb = _uniform_nbin(bins)
    route, mode, arrs, th = _os_fold_route(
        bank, st, int(X.shape[0]), int(X.shape[1]) // st["nc"], unb,
        thresholds)
    _note_route(route_name(route, mode), device_prep=_device_prep)
    return _scan_rows(route, mode, arrs, th, X,
                      torch.as_tensor(nv, device=dev), st, bins, buff_samps,
                      max_trig, calc_hist, unb, calc_triggers)


def scan_chunks_sharded(mesh, X, bank, thresholds, nc, buff_samps,
                        bins=None, max_trig=64, valid_lens=None,
                        calc_hist=True, calc_triggers=True,
                        _device_prep=False):
    """scan_chunks across the entries of ``mesh`` (detex_tpu
    scan.py:921-960): the batch X [B, Lc] (numpy or a tensor) is padded to
    a multiple of the mesh size with zero-length chunks (_pad_batch), each
    entry's run of rows goes straight to its device and is scanned there
    against the bank's copy on that device (mesh.replicated) by the route
    _os_fold_route picks for the per-shard batch, every shard dispatched
    before any result is read (_run_shards). Returns scan_chunks' outputs
    on the mesh's first device: the histograms summed, maxima and triggers
    in chunk order, cut back to B."""
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X, np.float32)
    nv = _valid_lens(bank, nc, X, valid_lens)
    X, nv, B = _pad_batch(mesh.size, X, nv)
    unb = _uniform_nbin(bins)
    Bs = int(X.shape[0]) // mesh.size
    # the route is chosen on the per-shard batch, as detex_tpu chooses it;
    # each copy of the bank caches its own derived arrays
    plans = [_os_fold_route(rep, st, Bs, int(X.shape[1]) // st["nc"], unb,
                            thresholds)
             for rep in _pmesh.replicated(mesh, bank)]
    _note_route(route_name(*plans[0][:2]), sharded=True,
                device_prep=_device_prep)

    def body(i, r0, r1):
        dev = mesh[i]
        route, mode, arrs, th = plans[i]
        return _scan_rows(route, mode, arrs, th,
                          _ds.to_device(X[r0:r1], dev),
                          torch.as_tensor(nv[r0:r1], device=dev), st, bins,
                          buff_samps, max_trig, calc_hist, unb,
                          calc_triggers)

    return _gather(mesh, _run_shards(mesh, int(X.shape[0]), body), B)


def _chunk_fn_raw(xc, Lv, H, arrs, thresholds, bins, n_c, nc, nfft2,
                  buff_samps, max_trig, dec, calc_hist, uniform_nbin,
                  calc_triggers):
    """One raw chunk of the "raw-demux" route (detex_tpu _chunk_fn_raw):
    xc [nc, L_raw], Lv its true raw sample count (int). ds_bank_demux_raw
    over blocks of TEMPLATE_BLOCK templates, so that its cross-spectra
    never hold more than one block (the DS values do not depend on the
    blocking), then _finish with nv = Lv // dec - n_c + 1."""
    Ufd2, sum_u, d_mask = arrs
    parts = [_prep.ds_bank_demux_raw(
        xc, Lv, H, Ufd2[s:s + TEMPLATE_BLOCK], sum_u[s:s + TEMPLATE_BLOCK],
        d_mask[s:s + TEMPLATE_BLOCK], n_c, nc, nfft2, dec)
        for s in range(0, sum_u.shape[0], TEMPLATE_BLOCK)]
    ds = parts[0] if len(parts) == 1 else torch.cat(parts)
    return _finish(ds, int(Lv) // dec - n_c + 1, thresholds, bins,
                   buff_samps, max_trig, calc_hist, uniform_nbin,
                   calc_triggers)


def scan_chunks_raw(Xc, lens, H, bank, thresholds, nc, buff_samps,
                    bins=None, max_trig=64, dec=1, mesh=None,
                    calc_hist=True, calc_triggers=True):
    """Batched scan of raw channel chunks with the device prep (detrend,
    bandpass by the response H over dec * nfft bins, decimation by
    ``dec``): Xc [B, nc, L_raw] zero-padded channels (numpy or a tensor),
    lens [B] their true raw per-channel sample counts. Returns
    scan_chunks' outputs.

    On an overlap-save bank: prep_multiplex_batch, then scan_chunks on the
    multiplexed chunks with valid lengths (lens // dec) * nc. On a
    full-length demuxed bank of any number of templates: route
    "raw-demux", ds_bank_demux_raw per chunk and template block. A
    multiplexed bank raises ValueError, as in detex_tpu. With a ``mesh`` of
    more than one entry the batch is sharded across it
    (scan_chunks_raw_sharded)."""
    if mesh is not None and mesh.size > 1:
        return scan_chunks_raw_sharded(
            mesh, Xc, lens, H, bank, thresholds, nc, buff_samps, bins=bins,
            max_trig=max_trig, dec=dec, calc_hist=calc_hist,
            calc_triggers=calc_triggers)
    dev = bank["sum_u"].device
    Xc = _ds.to_device(Xc, dev)
    lens = [int(v) for v in lens]
    kind = _ds.bank_kind(bank)
    if kind == "os":
        nfftp = (int(H.shape[0]) - 1) * 2 // int(dec)
        X, lens_mux = _prep.prep_multiplex_batch(Xc, lens, H, nfftp,
                                                 int(dec), int(nc))
        return scan_chunks(X, bank, thresholds, nc, buff_samps, bins=bins,
                           max_trig=max_trig, valid_lens=lens_mux,
                           calc_hist=calc_hist, calc_triggers=calc_triggers,
                           _device_prep=True)
    if kind != "demux":
        raise ValueError("scan_chunks_raw requires a demuxed bank")
    if bins is None:
        bins = DEFAULT_BINS
    _note_route("raw-demux", device_prep=True)
    return _raw_demux_rows(bank, Xc, lens, H, thresholds, nc, buff_samps,
                           bins, max_trig, dec, calc_hist, calc_triggers)


def _raw_demux_rows(bank, Xc, lens, H, thresholds, nc, buff_samps, bins,
                    max_trig, dec, calc_hist, calc_triggers):
    """The "raw-demux" route over raw chunks Xc [B, nc, L_raw] on the
    device of ``bank`` (a full-length demuxed bank): one _chunk_fn_raw a
    chunk, the outputs stacked as scan_chunks returns them."""
    dev = bank["sum_u"].device
    arrs = (bank["Ufd2"], bank["sum_u"], bank["d_mask"])
    th = torch.as_tensor(np.asarray(thresholds, np.float32), device=dev)
    bins_t = torch.as_tensor(np.asarray(bins), dtype=torch.float32,
                             device=dev)
    unb = _uniform_nbin(bins)
    outs = [_chunk_fn_raw(Xc[b], lens[b], H, arrs, th, bins_t, bank["n_c"],
                          int(nc), bank["nfft2"], int(buff_samps),
                          int(max_trig), int(dec), bool(calc_hist), unb,
                          bool(calc_triggers)) for b in range(Xc.shape[0])]
    return _stack_chunks(outs, Xc.shape[0], int(bank["sum_u"].shape[0]),
                         bins_t.shape[0] - 1, bool(calc_triggers), dev)


def scan_chunks_raw_sharded(mesh, Xc, lens, H, bank, thresholds, nc,
                            buff_samps, bins=None, max_trig=64, dec=1,
                            calc_hist=True, calc_triggers=True):
    """scan_chunks_raw across the entries of ``mesh`` (detex_tpu
    scan.py:963-1006): the raw batch Xc [B, nc, L_raw] and its lens padded
    to a multiple of the mesh size with zero-length chunks, and each
    entry's rows prepared and scanned on its device. On an overlap-save
    bank each shard runs prep_multiplex_batch and then the route picked
    for the per-shard batch, with valid DS lengths
    max((lens_mux - n) // nc + 1, 0); on a full-length demuxed bank the
    "raw-demux" route a chunk. Returns scan_chunks_sharded's outputs."""
    if bins is None:
        bins = DEFAULT_BINS
    kind = _ds.bank_kind(bank)
    if kind not in ("os", "demux"):
        raise ValueError("scan_chunks_raw requires a demuxed bank")
    if not isinstance(Xc, torch.Tensor):
        Xc = np.asarray(Xc, np.float32)
    lens = np.asarray([int(v) for v in lens], np.int64)
    Xc, lens, B = _pad_batch(mesh.size, Xc, lens)
    reps = _pmesh.replicated(mesh, bank)
    dec, nc = int(dec), int(nc)
    if kind == "demux":
        _note_route("raw-demux", sharded=True, device_prep=True)

        def body(i, r0, r1):
            dev = mesh[i]
            return _raw_demux_rows(
                reps[i], _ds.to_device(Xc[r0:r1], dev),
                lens[r0:r1].tolist(), H.to(dev), thresholds, nc, buff_samps,
                bins, max_trig, dec, calc_hist, calc_triggers)

        return _gather(mesh, _run_shards(mesh, int(Xc.shape[0]), body), B)
    st = _bank_statics(bank, nc)
    unb = _uniform_nbin(bins)
    nfftp = (int(H.shape[0]) - 1) * 2 // dec
    n = int(bank["n"])
    # the route is chosen on the per-shard batch of multiplexed chunks
    Bs = int(Xc.shape[0]) // mesh.size
    plans = [_os_fold_route(rep, st, Bs, int(Xc.shape[2]) // dec, unb,
                            thresholds) for rep in reps]
    _note_route(route_name(*plans[0][:2]), sharded=True, device_prep=True)

    def body(i, r0, r1):
        dev = mesh[i]
        route, mode, arrs, th = plans[i]
        X, lens_mux = _prep.prep_multiplex_batch(
            _ds.to_device(Xc[r0:r1], dev), lens[r0:r1].tolist(), H.to(dev),
            nfftp, dec, nc)
        nv = np.maximum((np.asarray(lens_mux) - n) // nc + 1, 0)
        return _scan_rows(route, mode, arrs, th, X,
                          torch.as_tensor(nv.astype(np.int32), device=dev),
                          st, bins, buff_samps, max_trig, calc_hist, unb,
                          calc_triggers)

    return _gather(mesh, _run_shards(mesh, int(Xc.shape[0]), body), B)
