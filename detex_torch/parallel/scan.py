"""
Batched continuous-data scan over an overlap-save bank.

Namesake of detex_tpu/parallel/scan.py, ported for its route "fold" with
the fused modes "sub+fp" / "net+fp": one fwd_prep_fold launch preps the
whole chunk batch, one spec_ds_fold launch turns it into per-row block
maxima, histograms and (with ``calc_triggers``) the DS array the trigger
extraction reads. The template-blocked route (S > TEMPLATE_BLOCK), the
per-chunk route, the unfused fold path and the multi-device scan raise
NotImplementedError naming their ROADMAP items.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

import detex_torch
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


def route_name(mode):
    """Readable kernel route of _os_fold_route's mode ("net+fp" /
    "sub+fp"; the only route ported is "fold")."""
    return "fused-%s+fusedprep" % mode[:3]


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


def _bank_statics(bank, nc):
    if not bank.get("os"):
        raise NotImplementedError(
            "only overlap-save banks are ported: ROADMAP A9")
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


def _os_fold_route(bank, st, B, thresholds, unb):
    """Kernel routing for overlap-save banks. Returns (specds_mode, arrs,
    thresholds_dev) of route "fold" with mode "net+fp" / "sub+fp"; every
    other route detex_tpu would take raises NotImplementedError."""
    if st["S"] > TEMPLATE_BLOCK:
        raise NotImplementedError(
            "template-blocked route (S = %d > %d): ROADMAP A3"
            % (st["S"], TEMPLATE_BLOCK))
    if not unb:
        raise NotImplementedError(
            "non-uniform histogram bins take the per-chunk route: "
            "ROADMAP A9")
    mode = _ds.spec_ds_mode(B, st["S"], int(bank["Dmax"]), st["n_c"],
                            st["nc"], st["nfft"])
    if mode is None:
        raise NotImplementedError(
            "geometry n_c=%d blk=%d needs the unfused fold path: ROADMAP A9"
            % (st["n_c"], st["nfft"]))
    if not _ds.fwd_prep_ok(st["n_c"], st["nc"], st["nfft"]):
        raise NotImplementedError(
            "geometry n_c=%d blk=%d needs the unfused prep: ROADMAP A9"
            % (st["n_c"], st["nfft"]))
    th = torch.as_tensor(np.asarray(thresholds, np.float32),
                         device=bank["sum_u"].device)
    return mode + "+fp", _specds_arrs(bank), th


def _no_trig(B, S, device):
    """Zero-capacity trigger outputs for calc_triggers=False."""
    return (torch.zeros((B, S, 0), dtype=torch.int32, device=device),
            torch.zeros((B, S, 0), dtype=torch.float32, device=device),
            torch.zeros((B, S), dtype=torch.int32, device=device))


def _fold_chunks_fn(X, NV, arrs, thresholds, n_c, nc, blk_fft, buff_samps,
                    max_trig, S, calc_hist, uniform_nbin, specds_mode,
                    calc_triggers=True):
    """Fused fold scan of a chunk batch X [B, Lc]: (hist [S, nbin] int32
    summed over chunks, maxds [B, S], tidx [B, S, K] int32, tval [B, S, K],
    tcnt [B, S] int32). In mode "sub" the kernel's rows are (template,
    chunk): only the summaries are transposed back, never the DS array.
    ``calc_triggers=False`` runs the kernel summary-only (no DS array) and
    returns zero-capacity trigger outputs."""
    B = X.shape[0]
    L_c = X.shape[1] // nc
    nbin = uniform_nbin if calc_hist else 0
    mode = specds_mode[:3]
    Fr, Fi, a, power = _ds.os_prep_batch_fused(X, n_c, nc, blk_fft)
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
    tidx, tcnt = _triggers.extract_triggers_pyramid_pm(
        dsf, pyrf, thf, buff_samps, max_triggers=max_trig)
    safe = tidx.clamp(min=0).to(torch.int64)
    vals = torch.gather(dsf, 1, safe)
    tval = torch.where(tidx >= 0, vals, torch.full_like(vals, float("nan")))
    return hist_tot, maxds, tr(tidx), tr(tval), tr(tcnt)


def scan_chunks(X, bank, thresholds, nc, buff_samps, bins=None, max_trig=64,
                valid_lens=None, mesh=None, calc_hist=True,
                calc_triggers=True):
    """Batched scan: X [B, Lc] -> (hist [S, nbin], maxds [B, S],
    trig_idx [B, S, K], trig_val [B, S, K], trig_count [B, S]) as tensors
    on the bank's device.

    ``valid_lens`` ([B], optional) gives each chunk's true multiplexed
    sample count when rows are zero-padded. ``calc_hist=False`` returns a
    zero histogram. ``calc_triggers=False`` (the engine's summary-only
    mode) skips trigger extraction: trigger outputs come back
    zero-capacity and the DS array is never written. X may be a numpy
    array or a tensor; it is moved to the bank's device."""
    if mesh is not None:
        raise NotImplementedError("multi-device scan: ROADMAP A11")
    if bins is None:
        bins = DEFAULT_BINS
    st = _bank_statics(bank, nc)
    dev = bank["sum_u"].device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    nv = _valid_lens(bank, nc, X, valid_lens)
    unb = _uniform_nbin(bins)
    mode, arrs, th = _os_fold_route(bank, st, int(X.shape[0]), thresholds,
                                    unb)
    _note_route(route_name(mode))
    return _fold_chunks_fn(
        X, torch.as_tensor(nv, device=dev), arrs, th, st["n_c"], st["nc"],
        st["nfft"], int(buff_samps), int(max_trig), st["S"],
        bool(calc_hist), unb, mode, calc_triggers=bool(calc_triggers))
