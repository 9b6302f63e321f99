"""
Trigger extraction: iterative argmax-above-threshold with suppression,
batched over rows.

Namesake of detex_tpu/ops/triggers.py. The reference mutates the DS array
in a while loop (Detex _CreateCoeffArray detect.py:390-445 and
_downPlayArrayAroundMax :545-557); here every row of a batch steps
together in one Python loop, which stops once no row is above its
threshold (a row below threshold is never changed again, so it never rises
again). Two forms:

  extract_triggers             over the full statistic, each step zeroing
                               the suppressed interval in place (the dense
                               re-verify: a few rows of known length);
  extract_triggers_pyramid_pm  over per-block maxima (the pyramid the
                               fused scan kernel emits), re-reading one
                               block per step (the serving scan);
  extract_triggers_topk,       the fixed-capacity forms of the full-length
  extract_triggers_pyramid     route (parallel/scan._extract): the full-row
                               form, and the pyramid built here from the
                               row in blocks of 512.

Suppression mirrors the reference's three-case zeroing with row length L:

    index <  buff + 1     -> zero [0, index + buff)
    index >  L - buff     -> zero [index - buff, L)
    otherwise             -> zero [index - buff, index + buff)

Ties go to the first occurrence (torch.max / torch.argmax, like
jnp.argmax).
"""
from __future__ import annotations

import numpy as np
import torch

from detex_torch.ops import stalta as _stalta

# capacity of extract_triggers_np / extract_triggers when none is given
# (detex_tpu's DEFAULT_MAX_TRIGGERS)
DEFAULT_MAX_TRIGGERS = 512


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


def extract_triggers_pyramid(ceval, threshold, buff_samps, max_triggers=64,
                             block=512):
    """Triggers of every row of ceval [R, L] at per-row thresholds [R]
    through a block-max pyramid built here (pad positions -inf), with
    detex_tpu's block of 512; the three-case clamp uses the true L.
    Output-identical to extract_triggers_topk. Returns (idx
    [R, max_triggers] int32, -1 past the row's count; count [R] int32)."""
    R, L = ceval.shape
    nblk = -(-L // block)
    cp = torch.nn.functional.pad(ceval.to(torch.float32),
                                 (0, nblk * block - L), value=float("-inf"))
    pyr0 = cp.reshape(R, nblk, block).amax(dim=-1)
    return _pyramid_suppress_scan(cp, pyr0, threshold, buff_samps,
                                  max_triggers, block, L)


def extract_triggers_topk(ceval, threshold, buff_samps, max_triggers=64):
    """Triggers of every row of ceval [R, L] at per-row thresholds [R] with
    a fixed capacity (detex_tpu's extract_triggers_topk): extract_triggers'
    steps, padded to ``max_triggers`` columns. Returns (idx
    [R, max_triggers] int32, -1 past the row's count; count [R] int32)."""
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=ceval.device).reshape(-1)
    idx, cnt = extract_triggers(ceval, thr, buff_samps, max_triggers)
    idx = torch.nn.functional.pad(idx, (0, max_triggers - idx.shape[1]),
                                  value=-1)
    return idx.to(torch.int32), cnt.to(torch.int32)


def extract_triggers_np(ceval, threshold, buff_samps,
                        max_triggers=DEFAULT_MAX_TRIGGERS):
    """Host float64 twin of extract_triggers on one row: the same
    argmax / suppression semantics without the float32 cast. Returns int64
    indices in emission order."""
    c = np.array(ceval, dtype=np.float64, copy=True)
    L = len(c)
    out = []
    while len(out) < max_triggers and L and np.max(c) >= threshold:
        i = int(np.argmax(c))
        out.append(i)
        if i < buff_samps + 1:
            lo, hi = 0, i + buff_samps
        elif i > L - buff_samps:
            lo, hi = i - buff_samps, L
        else:
            lo, hi = i - buff_samps, i + buff_samps
        c[lo:hi] = 0.0
    return np.asarray(out, np.int64)


def extract_triggers(ceval, threshold, buff_samps,
                     max_triggers=DEFAULT_MAX_TRIGGERS):
    """Triggers of every row of ceval [R, L] (float32) at per-row
    thresholds [R] (or one scalar): trigger while the row's maximum is
    >= its threshold, at most ``max_triggers`` per row. Each step takes
    every row's maximum and zeroes the suppressed interval of the rows
    that triggered, so a step costs O(R*L).

    Returns (idx [R, k] int64 in emission order, -1 past the row's count;
    count [R] int64), where k <= max_triggers is the number of steps
    taken, i.e. the largest count."""
    c = ceval.to(torch.float32).clone()
    R, L = c.shape
    dev = c.device
    thr = torch.as_tensor(threshold, dtype=torch.float32,
                          device=dev).expand(R)
    pos = torch.arange(L, device=dev)
    cols = []
    for _ in range(int(max_triggers) if L else 0):
        mx, i = c.max(dim=1)
        valid = mx >= thr
        if not bool(valid.any()):
            break
        lo, hi = _suppress_bounds(i, buff_samps, L)
        c.masked_fill_(valid[:, None] & (pos >= lo[:, None])
                       & (pos < hi[:, None]), 0.0)
        cols.append(torch.where(valid, i, torch.full_like(i, -1)))
    idx = (torch.stack(cols, dim=1) if cols
           else torch.zeros((R, 0), dtype=torch.int64, device=dev))
    return idx, (idx >= 0).sum(dim=1)


def trigger_rows_device(rows, thr, L, sta_n, lta_n, buff_samps,
                        max_triggers, use_stalta):
    """The engine's per-row re-verify chain (detect._materializeOne) on the
    rows' device, in the host order:

      1. truncate to the chunk's ``L`` valid windows (L >= 1);
      2. if max(row) > 1.1, zero non-finite values (a NaN maximum leaves
         the row as it is, as numpy's NaN-propagating max does);
      3. optional centered STA/LTA (stalta._stalta_kernel);
      4. extract_triggers at the per-row thresholds ``thr`` [R];
      5. gather DS and STA/LTA values at the trigger indices.

    rows [R, >= L] float32; ``sta_n`` / ``lta_n`` are the clamped window
    lengths. Returns (idx [R, k] int64, -1 padded; count [R] int64;
    ds_at [R, k] float32; stalta_at [R, k] float32, zeros when
    ``use_stalta`` is False), k as in extract_triggers."""
    r = rows[:, :L].to(torch.float32)
    mx = r.amax(dim=1, keepdim=True)
    r = torch.where(mx > 1.1,
                    torch.where(torch.isfinite(r), r, torch.zeros_like(r)),
                    r)
    idx, cnt = extract_triggers(r, thr, buff_samps, max_triggers)
    safe = idx.clamp(min=0)
    dsv = torch.gather(r, 1, safe)
    if use_stalta:
        slv = torch.gather(_stalta._stalta_kernel(r, sta_n, lta_n), 1, safe)
    else:
        slv = torch.zeros_like(dsv)
    return idx, cnt, dsv, slv
