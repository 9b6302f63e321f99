"""
STA/LTA of the detection statistic, batched over rows.

Namesake of detex_tpu/ops/stalta.py (``_stalta_kernel``, ``ds_stalta``):
the centered STA/LTA of the reference (detect.py:501-524) with its NaN edge
fill (_replaceNanWithMean, detect.py:516-524). The classic STA/LTA of the
FAS noise veto is not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import torch

from detex_torch.ops.rolling import rolling_mean_centered


def _fill_edges(arr):
    """Per row: leading NaNs take the value at first+1, trailing NaNs the
    value at last (first / last: the row's first and last non-NaN)."""
    L = arr.shape[-1]
    valid = (~torch.isnan(arr)).to(torch.int32)
    first = valid.argmax(dim=-1, keepdim=True)
    last = L - 1 - valid.flip(-1).argmax(dim=-1, keepdim=True)
    lead = arr.gather(-1, (first + 1).clamp(max=L - 1))
    trail = arr.gather(-1, last)
    idx = torch.arange(L, device=arr.device)
    out = torch.where(idx < first, lead, arr)
    return torch.where(idx > last, trail, out)


def _stalta_kernel(c, sta, lta):
    """Centered STA/LTA of every row of c [R, L] (last axis) with window
    lengths ``sta`` (<= 1: the raw |c|) and ``lta``."""
    ab = c.abs()
    sta_arr = ab if sta <= 1 else rolling_mean_centered(ab, sta)
    lta_arr = rolling_mean_centered(ab, lta)
    return _fill_edges(sta_arr) / _fill_edges(lta_arr)


def ds_stalta(c, lta_samps, sta_samps):
    """Centered STA/LTA of detection-statistic rows c [..., L] matching the
    reference (_getStaLtaArray): an STA window of 0 or 1 uses the raw
    |DS|."""
    sta = max(int(sta_samps), 0) or 1
    lta = max(int(lta_samps), 1)
    return _stalta_kernel(c, sta, lta)
