"""
Batched continuous-data scan over an overlap-save bank.

Namesake of detex_tpu/parallel/scan.py for banks of up to TEMPLATE_BLOCK
templates on one device. scan_chunks takes detex_tpu's route
(_os_fold_route), in its order:

  fused   one spec_ds_fold launch over the whole chunk batch, prepped by
          fwd_prep_fold ("fused-net+fusedprep", "fused-sub+fusedprep") or,
          where that kernel refuses the geometry (n_c > W), by
          os_prep_batch_pair with rfft_ct_half ("fused-net", "fused-sub");
  fold    the unfused batch: os_prep_batch + os_block_scan_batch (block
          transforms, then ds_finalize_os_fold with the histogram);
  plain   one chunk at a time (_chunk_fn): os_prep + os_block_scan
          (ds_finalize_os_scan, or ds_finalize_os and hist_uniform where the
          block is too wide for the scan form), non-uniform bins by sort and
          search.

The caps that send a batch down the list are detex_tpu's (ops/ds.py
FUSED_DS_BYTES, FOLD_CB_BYTES); its Pallas tile budgets have no
counterpart here (ROADMAP C20). The template-blocked route
(S > TEMPLATE_BLOCK) and the multi-device scan raise NotImplementedError
naming their ROADMAP items.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

import detex_torch
from detex_torch.ops import cuda_kernels as _ck
from detex_torch.ops import ds as _ds
from detex_torch.ops import triggers as _triggers

DEFAULT_BINS = np.linspace(0, 1, 401)

# templates per block of detex_tpu's template-blocked route; larger banks
# take that route, which is not ported yet (ROADMAP A3)
TEMPLATE_BLOCK = 128

# Kernel-route observability: every scan records the route it dispatched
# in this counter and logs each new route once.
ROUTE_COUNTS = Counter()
_ROUTES_LOGGED = set()


def route_name(route, mode):
    """Readable kernel route from _os_fold_route's (route, mode), as
    detex_tpu names it."""
    if route != "fold":
        return "plain"
    fp = "+fusedprep" if (mode or "").endswith("+fp") else ""
    return {"net": "fused-net", "sub": "fused-sub"}.get(
        (mode or "")[:3], "fold") + fp


def _note_route(name):
    """Count, and log once per unique name, the route a scan dispatched."""
    ROUTE_COUNTS[name] += 1
    if name not in _ROUTES_LOGGED:
        _ROUTES_LOGGED.add(name)
        detex_torch.log(__name__, "scan kernel route: %s" % name)
    return name


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
    _ds._require_os(bank)
    return dict(n_c=bank["n_c"], nc=int(nc),
                nfft=bank["blk_fft"], S=int(bank["sum_u"].shape[0]))


def _specds_arrs(bank):
    """(ur, ui, sum_u, d_mask) of the fused spec -> DS kernel, unblocked."""
    ur, ui = _ds.bank_spec_pair(bank)
    return ur, ui, bank["sum_u"], bank["d_mask"]


def _valid_lens(bank, nc, X, valid_lens):
    """Per-chunk count of valid DS samples (windows fully inside real
    data)."""
    n = bank["n"]
    if valid_lens is None:
        valid_lens = [X.shape[1]] * X.shape[0]
    return np.asarray([(int(v) - n) // nc + 1 for v in valid_lens],
                      np.int32)


def _fold_scan_ok(bank, st, B, L_c, unb):
    """detex_tpu's test for the batch routes (scan.py:351-373): uniform
    bins, and either the fused kernel's geometry with its DS array under
    FUSED_DS_BYTES, or the unfused batch's with its inverse blocks under
    FOLD_CB_BYTES."""
    if not unb:                 # hist width comes from the uniform bins
        return False
    Dmax = int(bank["Dmax"])
    _, _, _, W, m = _ds._os_geometry(L_c, st["n_c"], st["nfft"])
    if _ds.spec_ds_mode(B, st["S"], Dmax, st["n_c"], st["nc"], st["nfft"]):
        return B * st["S"] * m * W * 4 <= _ds.FUSED_DS_BYTES
    if B * st["S"] * Dmax * m * st["nfft"] * 4 > _ds.FOLD_CB_BYTES:
        return False
    return _ds.fold_scan_supported(st["n_c"], st["nfft"])


def _os_fold_route(bank, st, B, L_c, unb, thresholds):
    """Kernel routing for overlap-save banks (detex_tpu scan.py:619-656).
    Returns (route, mode, arrs, thresholds_dev): route "fold" with mode
    "net" / "sub" (+"+fp" with the fused prep) and arrs (ur, ui, sum_u,
    d_mask) for the fused kernel, route "fold" with mode None and arrs
    (Ufd2, sum_u, d_mask) for the unfused batch, or route None (the
    per-chunk loop) with the same arrs."""
    if st["S"] > TEMPLATE_BLOCK:
        raise NotImplementedError(
            "template-blocked route (S = %d > %d): ROADMAP A3"
            % (st["S"], TEMPLATE_BLOCK))
    th = torch.as_tensor(np.asarray(thresholds, np.float32),
                         device=bank["sum_u"].device)
    raw = (bank["Ufd2"], bank["sum_u"], bank["d_mask"])
    if not _fold_scan_ok(bank, st, B, L_c, unb):
        return None, None, raw, th
    mode = _ds.spec_ds_mode(B, st["S"], int(bank["Dmax"]), st["n_c"],
                            st["nc"], st["nfft"])
    if mode is None:
        return "fold", None, raw, th
    if _ds.fwd_prep_ok(st["n_c"], st["nc"], st["nfft"]):
        mode += "+fp"
    return "fold", mode, _specds_arrs(bank), th


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
    """Batch scan of a chunk batch X [B, Lc]: (hist [S, nbin] int32 summed
    over chunks, maxds [B, S], tidx [B, S, K] int32, tval [B, S, K],
    tcnt [B, S] int32). ``specds_mode`` None runs the unfused batch
    (arrs (Ufd2, sum_u, d_mask)); otherwise the fused kernel (arrs from
    _specds_arrs), whose rows in mode "sub" are (template, chunk): only the
    summaries are transposed back, never the DS array.
    ``calc_triggers=False`` returns zero-capacity trigger outputs, and the
    fused kernel then runs summary-only (no DS array)."""
    B = X.shape[0]
    L_c = X.shape[1] // nc
    nbin = uniform_nbin if calc_hist else 0
    if specds_mode is None:
        return _unfused_chunks_fn(X, NV, arrs, thresholds, n_c, nc, blk_fft,
                                  buff_samps, max_trig, S, nbin,
                                  uniform_nbin, calc_triggers)
    mode = specds_mode[:3]
    prep = (_ds.os_prep_batch_fused if specds_mode.endswith("+fp")
            else _ds.os_prep_batch_pair)
    Fr, Fi, a, power = prep(X, n_c, nc, blk_fft)
    dsf, pyrf, hist = _ds.os_scan_batch_fused(
        Fr, Fi, a, power, arrs[0], arrs[1], arrs[2], arrs[3], mode, n_c, nc,
        blk_fft, L_c, NV, nbin=nbin, emit_ds=calc_triggers)
    del Fr, Fi, a, power
    if mode == "sub":   # rows (s, b)
        thf = thresholds[:, None].expand(S, B).reshape(-1)

        def tr(x):
            return x.reshape((S, B) + x.shape[1:]).transpose(0, 1)
    else:               # rows (b, s)
        thf = thresholds[None, :].expand(B, S).reshape(-1)

        def tr(x):
            return x.reshape((B, S) + x.shape[1:])
    maxds = tr(pyrf.amax(dim=-1))
    if calc_hist:
        hist_tot = (hist.reshape(S, B, nbin).sum(dim=1) if mode == "sub"
                    else hist.reshape(B, S, nbin).sum(dim=0))
        hist_tot = hist_tot.to(torch.int32)
    else:
        hist_tot = torch.zeros((S, uniform_nbin), dtype=torch.int32,
                               device=X.device)
    if not calc_triggers:
        return (hist_tot, maxds) + _no_trig(B, S, X.device)
    tidx, tval, tcnt = _triggers_of(dsf, pyrf, thf, buff_samps, max_trig)
    return hist_tot, maxds, tr(tidx), tr(tval), tr(tcnt)


def _unfused_chunks_fn(X, NV, arrs, thresholds, n_c, nc, blk_fft,
                       buff_samps, max_trig, S, nbin, uniform_nbin,
                       calc_triggers):
    """_fold_chunks_fn's unfused batch (detex_tpu scan.py:442-459): one
    os_prep_batch and one os_block_scan_batch over the whole batch, the
    histogram from ds_finalize_os_fold (``nbin``)."""
    B = X.shape[0]
    F, a, power = _ds.os_prep_batch(X, n_c, nc, blk_fft)
    ds, pyr, hist = _ds.os_block_scan_batch(
        F, a, power, arrs[0], arrs[1], arrs[2], n_c, nc, blk_fft,
        X.shape[1] // nc, NV, nbin=nbin)
    del F, a, power
    maxds = pyr.amax(dim=-1)                            # [B, S]
    hist_tot = (hist.sum(dim=0).to(torch.int32) if nbin else
                torch.zeros((S, uniform_nbin), dtype=torch.int32,
                            device=X.device))
    if not calc_triggers:
        return (hist_tot, maxds) + _no_trig(B, S, X.device)
    thf = thresholds[None, :].expand(B, S).reshape(-1)
    tidx, tval, tcnt = _triggers_of(ds.reshape(B * S, -1),
                                    pyr.reshape(B * S, -1), thf,
                                    buff_samps, max_trig)
    K = tidx.shape[-1]
    return (hist_tot, maxds, tidx.reshape(B, S, K), tval.reshape(B, S, K),
            tcnt.reshape(B, S))


def _chunk_fn(x, nv, arrs, thresholds, bins, n_c, nc, nfft, buff_samps,
              max_trig, calc_hist, uniform_nbin, calc_triggers):
    """One chunk of the per-chunk route (detex_tpu scan.py:258-348, its
    overlap-save branch): x [Lc], nv its valid DS length (a 0-d int32 on
    the device). Returns (hist [S, nbins] int32, maxds [S], and
    (tidx [S, K], tval [S, K], tcnt [S]) or None without triggers); the
    chunk's DS array is freed on return."""
    S = arrs[1].shape[0]
    F, a, power = _ds.os_prep(x, n_c, nc, nfft)
    ds, pyr, fused_hist = _ds.os_block_scan(
        F, a, power, arrs[0], arrs[1], arrs[2], n_c, nc, nfft,
        x.shape[0] // nc, nv, nbin=uniform_nbin if calc_hist else 0)
    del F, a, power
    if not calc_hist:
        hist = torch.zeros((S, bins.shape[0] - 1), dtype=torch.int32,
                           device=x.device)
    elif fused_hist is not None:
        hist = fused_hist
    else:
        hist = _hist_rows(ds, bins, uniform_nbin)
    maxds = pyr.amax(dim=-1)
    trig = (_triggers_of(ds, pyr, thresholds, buff_samps, max_trig)
            if calc_triggers else None)
    return hist, maxds, trig


def _scan_chunks_loop(X, NV, arrs, thresholds, bins, n_c, nc, nfft,
                      buff_samps, max_trig, S, calc_hist, uniform_nbin,
                      calc_triggers):
    """The per-chunk route over a chunk batch X [B, Lc] (detex_tpu
    _scan_chunks_jit's lax.map as a loop): hist summed over chunks,
    maxds [B, S], triggers stacked [B, S, K]. Adds no host sync of its own;
    the trigger loop syncs once per step as everywhere."""
    B = X.shape[0]
    dev = X.device
    hist = torch.zeros((S, bins.shape[0] - 1), dtype=torch.int32, device=dev)
    maxds = torch.empty((B, S), dtype=torch.float32, device=dev)
    trig = []
    for b in range(B):
        h, maxds[b], t = _chunk_fn(X[b], NV[b], arrs, thresholds, bins, n_c,
                                   nc, nfft, buff_samps, max_trig, calc_hist,
                                   uniform_nbin, calc_triggers)
        hist += h
        trig.append(t)
    if not calc_triggers:
        return (hist, maxds) + _no_trig(B, S, dev)
    return (hist, maxds) + tuple(torch.stack(parts) for parts in zip(*trig))


def scan_chunks(X, bank, thresholds, nc, buff_samps, bins=None, max_trig=64,
                valid_lens=None, mesh=None, calc_hist=True,
                calc_triggers=True):
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
    the bank's device."""
    if mesh is not None:
        raise NotImplementedError("multi-device scan: ROADMAP A11")
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    dev = bank["sum_u"].device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    nv = _valid_lens(bank, nc, X, valid_lens)
    unb = _uniform_nbin(bins)
    route, mode, arrs, th = _os_fold_route(
        bank, st, int(X.shape[0]), int(X.shape[1]) // st["nc"], unb,
        thresholds)
    _note_route(route_name(route, mode))
    NV = torch.as_tensor(nv, device=dev)
    if route == "fold":
        return _fold_chunks_fn(
            X, NV, arrs, th, st["n_c"], st["nc"], st["nfft"],
            int(buff_samps), int(max_trig), st["S"], bool(calc_hist), unb,
            mode, calc_triggers=bool(calc_triggers))
    bins_t = torch.as_tensor(np.asarray(bins), dtype=torch.float32,
                             device=dev)
    return _scan_chunks_loop(
        X, NV, arrs, th, bins_t, st["n_c"], st["nc"], st["nfft"],
        int(buff_samps), int(max_trig), st["S"], bool(calc_hist), unb,
        bool(calc_triggers))
