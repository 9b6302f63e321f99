"""
STA/LTA of the detection statistic, batched over rows.

Namesake of detex_tpu/ops/stalta.py (``_stalta_kernel``, ``ds_stalta``):
the centered STA/LTA of the reference (detect.py:501-524) with its NaN edge
fill (_replaceNanWithMean, detect.py:516-524), on tensors, and its float64
host twin ds_stalta_np for the engine's dtype="double" path, and the
classic STA/LTA of the FAS noise veto (classic_sta_lta, host float64).
"""
from __future__ import annotations

import numpy as np
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


def _replace_nan_with_edges(arr):
    """Host float64 _fill_edges of one row (reference _replaceNanWithMean,
    detect.py:516-524): leading NaNs take the value at first+1, trailing
    NaNs the value at last."""
    arr = np.asarray(arr, dtype=np.float64)
    ind = np.where(~np.isnan(arr))[0]
    if len(ind) == 0:
        return arr
    first, last = ind[0], ind[-1]
    arr[:first] = arr[min(first + 1, len(arr) - 1)]
    arr[last + 1:] = arr[last]
    return arr


def _centered_mean_np(x, n):
    """float64 centered rolling mean of one row, labeled as
    rolling.rolling_mean_centered labels it (pandas center=True); NaN at
    the edges."""
    x = np.asarray(x, np.float64)
    c = np.cumsum(np.insert(x, 0, 0.0))
    mu = (c[n:] - c[:-n]) / n
    out = np.full(len(x), np.nan)
    start = (n - 1) - ((n - 1) // 2)
    out[start:start + len(mu)] = mu
    return out


def ds_stalta_np(c, lta_samps, sta_samps):
    """Host float64 twin of ds_stalta on one row (numpy in, numpy out), for
    the engine's dtype="double" path."""
    ab = np.abs(np.asarray(c, np.float64))
    sta = max(int(sta_samps), 1)
    lta = max(int(lta_samps), 1)
    sta_arr = ab if sta <= 1 else _centered_mean_np(ab, sta)
    lta_arr = _centered_mean_np(ab, lta)
    return (_replace_nan_with_edges(sta_arr) /
            _replace_nan_with_edges(lta_arr))


def classic_sta_lta(data, nsta, nlta):
    """Classic STA/LTA of one host row in float64 (obspy's
    classic_sta_lta): the ratio of trailing means of x^2, partial windows
    at the start divided by the full window length, the first ``nlta``
    samples and any non-finite ratio set to 0. The FAS noise veto
    (fas._checkSTALTA, reference fas.py:175-205)."""
    data = np.asarray(data, dtype=np.float64)
    nsta = max(int(nsta), 1)
    nlta = max(int(nlta), 1)
    sq = data ** 2
    c = np.cumsum(np.insert(sq, 0, 0.0))
    idx = np.arange(1, len(sq) + 1)
    sta = (c[idx] - c[idx - np.minimum(idx, nsta)]) / nsta
    lta = (c[idx] - c[idx - np.minimum(idx, nlta)]) / nlta
    with np.errstate(divide="ignore", invalid="ignore"):
        cft = sta / lta
    cft[:nlta] = 0.0
    cft[~np.isfinite(cft)] = 0.0
    return cft
