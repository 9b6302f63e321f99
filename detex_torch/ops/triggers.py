"""
Trigger extraction: iterative argmax-above-threshold with suppression,
batched over rows.

Namesake of detex_tpu/ops/triggers.py (``_pyramid_suppress_scan``,
``extract_triggers_pyramid_pm``). The reference mutates the DS array in a
while loop (Detex _CreateCoeffArray detect.py:390-445 and
_downPlayArrayAroundMax :545-557); here every row of a batch steps
together, at most ``max_triggers`` steps in one Python loop (it stops once
no row is above its threshold), over per-block maxima
(the pyramid the fused kernel emits) instead of the full statistic.
Suppression mirrors the reference's three-case zeroing with the PADDED row
length L:

    index <  buff + 1     -> zero [0, index + buff)
    index >  L - buff     -> zero [index - buff, L)
    otherwise             -> zero [index - buff, index + buff)

Ties go to the first occurrence (torch.argmax, like jnp.argmax).
"""
from __future__ import annotations

import torch


def _suppress_bounds(i, buff_samps, L):
    lo = torch.where(i < buff_samps + 1, torch.zeros_like(i),
                     i - buff_samps)
    hi = torch.where(i < buff_samps + 1, i + buff_samps,
                     torch.where(i > L - buff_samps,
                                 torch.full_like(i, L), i + buff_samps))
    return lo, hi


def _pyramid_suppress_scan(cp, pyr0, threshold, buff_samps, max_triggers,
                           block, L):
    """Argmax / suppression scan over block maxima, batched over rows.

    cp [R, nblk*block] statistic (pad positions -inf), pyr0 [R, nblk] its
    per-block maxima, threshold [R], L the length for the three-case clamp.
    Each step takes every row's pyramid argmax, recovers the exact
    first-occurrence index by re-reading that block with the row's earlier
    suppression intervals masked to 0.0 (the reference zeroes, not
    removes), zeroes the fully covered blocks of the summary and recomputes
    the two boundary blocks. Returns (idx [R, max_triggers] int32, -1 past
    the row's count; count [R] int32)."""
    R, nblk = pyr0.shape
    dev = cp.device
    cpb = cp.reshape(R, nblk, block)
    pyr = pyr0.to(torch.float32).clone()
    thr = threshold.to(device=dev, dtype=torch.float32).reshape(R)
    rows = torch.arange(R, device=dev)
    pos_in = torch.arange(block, device=dev)
    bidx = torch.arange(nblk, device=dev)
    los = torch.full((R, max_triggers), L + 1, dtype=torch.int64, device=dev)
    his = torch.zeros((R, max_triggers), dtype=torch.int64, device=dev)
    out = torch.full((R, max_triggers), -1, dtype=torch.int32, device=dev)

    def recompute(b, k):
        vals = cpb[rows, b]                                   # [R, block]
        if k:
            pos = b[:, None] * block + pos_in[None, :]
            inside = ((pos[:, None, :] >= los[:, :k, None]) &
                      (pos[:, None, :] < his[:, :k, None])).any(dim=1)
            vals = torch.where(inside, torch.zeros_like(vals), vals)
        mx, am = vals.max(dim=1)
        return mx, b * block + am

    for k in range(max_triggers):
        j = pyr.argmax(dim=1)
        valid = pyr[rows, j] >= thr
        # a row below threshold never rises again (only valid rows' maxima
        # change), so once no row is valid every later step emits -1
        if not bool(valid.any()):
            break
        _, i = recompute(j, k)
        lo, hi = _suppress_bounds(i, buff_samps, L)
        los[:, k] = torch.where(valid, lo, torch.full_like(lo, L + 1))
        his[:, k] = torch.where(valid, hi, torch.zeros_like(hi))
        full = (valid[:, None] & (bidx[None, :] * block >= lo[:, None]) &
                ((bidx[None, :] + 1) * block <= hi[:, None]))
        pyr = torch.where(full, torch.zeros_like(pyr), pyr)
        blo = torch.clamp(lo // block, 0, nblk - 1)
        bhi = torch.clamp((hi - 1) // block, 0, nblk - 1)
        for b in (blo, bhi):
            bm, _ = recompute(b, k + 1)
            pyr[rows, b] = torch.where(valid, bm, pyr[rows, b])
        out[:, k] = torch.where(valid, i.to(torch.int32),
                                torch.full_like(out[:, k], -1))
    count = (out >= 0).sum(dim=1).to(torch.int32)
    return out, count


def extract_triggers_pyramid_pm(ceval, pyr_max, threshold, buff_samps,
                                max_triggers=64, block=128):
    """Triggers of every row of ceval [R, L] given its precomputed
    block-max pyramid pyr_max [R, L // block] (pad positions pre-masked to
    -inf, as the fused kernel emits them) and per-row thresholds [R].
    Returns (idx [R, max_triggers] int32, count [R] int32)."""
    R, L = ceval.shape
    if pyr_max.shape[1] * block != L:
        raise ValueError("ceval length %d is not %d blocks of %d"
                         % (L, pyr_max.shape[1], block))
    return _pyramid_suppress_scan(ceval.to(torch.float32), pyr_max,
                                  threshold, buff_samps, max_triggers,
                                  block, L)
