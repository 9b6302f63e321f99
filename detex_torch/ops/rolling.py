"""
Rolling (sliding-window) statistics over the last axis.

Namesake of detex_tpu/ops/rolling.py. Every window sum subtracts the row
mean before the prefix sum and adds ``n * mean`` back per window (the
prefix stays an O(sqrt(L)) random walk), and the prefix runs in float64, so
window sums over million-sample rows keep ~1e-12 relative accuracy.
``rolling_sum_rows`` takes any leading dims; ``rolling_sum`` is
detex_tpu's one-row form of it. The prefix is two-level, as in
detex_tpu (there a triangular matmul for the TPU's matrix unit): PyTorch's
cumsum scans each row of a few long rows in one thread block on the card.
rolling_std is the host float64 form (numpy in, numpy out) that
native.rolling_std falls back to without the host library.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# samples per tile of the two-level prefix sum
PREFIX_TILE = 4096


def prefix_sum(x, dtype):
    """Inclusive prefix sum over the last axis in ``dtype``, as a cumsum
    within tiles of PREFIX_TILE samples (many short rows, which the card
    scans in parallel) plus the exclusive prefix of the tile totals.
    Exact for integer dtypes."""
    L = x.shape[-1]
    nt = -(-L // PREFIX_TILE)
    xp = F.pad(x.to(dtype), (0, nt * PREFIX_TILE - L))
    intra = torch.cumsum(xp.reshape(x.shape[:-1] + (nt, PREFIX_TILE)),
                         dim=-1, dtype=dtype)
    tot = intra[..., -1]
    off = torch.cumsum(tot, dim=-1, dtype=dtype) - tot
    return (intra + off[..., None]).reshape(
        x.shape[:-1] + (nt * PREFIX_TILE,))[..., :L]


def rolling_sum_rows(x, n):
    """Sliding-window sums over the last axis: x [..., L] -> float64
    [..., L - n + 1]."""
    x = x.to(torch.float64)
    mu = x.mean(dim=-1, keepdim=True)
    c = prefix_sum(x - mu, torch.float64)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    k = max(c.shape[-1] - n, 0)
    return c[..., n:] - c[..., :k] + n * mu


def rolling_sum(x, n):
    """Sliding-window sums of one row x [L] (a tensor, on its own device;
    a host array goes to the CPU): float64 [L - n + 1] (detex_tpu's
    rolling_sum)."""
    return rolling_sum_rows(torch.as_tensor(x), n)


def rolling_mean(x, n):
    """Sliding-window mean over the last axis, float64 [..., L - n + 1]."""
    return rolling_sum_rows(x, n) / n


def rolling_mean_var(x, n):
    """Sliding-window mean and population variance (ddof 0) over the last
    axis, float64 [..., L - n + 1] each (the normalization of the
    cross-correlation, ops/xcorr.py)."""
    x = x.to(torch.float64)
    mu = rolling_mean(x, n)
    return mu, (rolling_mean(x * x, n) - mu * mu).clamp(min=0.0)


def rolling_mean_centered(x, n):
    """Centered rolling mean matching ``pd.rolling_mean(x, n,
    center=True)`` over the last axis: the trailing window ending at i is
    labeled at i - (n-1)//2, positions without a full window are NaN.
    Same shape and dtype as x (the sums run in float64)."""
    L = x.shape[-1]
    mu = rolling_mean(x, n).to(x.dtype)
    out = torch.full_like(x, float("nan"))
    start = (n - 1) - ((n - 1) // 2)
    out[..., start:start + mu.shape[-1]] = mu
    return out


def window_stats_rows(xc, n_c, n):
    """DS window statistics from demuxed rows xc [B, nc, L_c]: (a, power)
    float32 [B, L_c - n_c + 1], the mean and n * sample variance of the
    multiplexed window behind each output (reference detect.py:566-568).

    A window whose n multiplexed samples are all equal (a zero-filled gap)
    gets power exactly 0, which the DS finalize turns into inf (DS 0).
    Rounding in the sums would otherwise leave a tiny positive power there
    and turn the gap into large, meaningless DS values; the test is an
    exact integer count of sample-to-sample changes inside the window."""
    B, nc, L_c = xc.shape
    flat = xc.reshape(B * nc, L_c).to(torch.float64)
    s1 = rolling_sum_rows(flat, n_c).reshape(B, nc, -1).sum(dim=1)
    s2 = rolling_sum_rows(flat * flat, n_c).reshape(B, nc, -1).sum(dim=1)
    a = s1 / n
    var_samp = (s2 - s1 * s1 / n) / (n - 1.0)
    power = var_samp.clamp(min=0.0) * n
    mux = xc.transpose(1, 2).reshape(B, L_c * nc)
    steps = prefix_sum(mux[:, 1:] != mux[:, :-1], torch.int32)
    steps = torch.cat([torch.zeros_like(steps[:, :1]), steps], dim=1)
    o = torch.arange(s1.shape[1], device=xc.device) * nc
    const = steps[:, o + n - 1] == steps[:, o]
    power = torch.where(const, torch.zeros_like(power), power)
    return a.to(torch.float32), power.to(torch.float32)


def rolling_std(x, n):
    """Trailing rolling sample standard deviation (ddof 1) of a host row,
    in float64: length len(x) - n + 1, empty when x is shorter than n (the
    SNR noise level of the engine's magnitudes, which both packages take
    from native.rolling_std; this is its numpy form)."""
    x = np.asarray(x, dtype=np.float64)
    if len(x) < n:
        return np.array([])
    c = np.cumsum(np.insert(x, 0, 0.0))
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    s = c[n:] - c[:-n]
    s2 = c2[n:] - c2[:-n]
    return np.sqrt(np.maximum((s2 - s * s / n) / (n - 1), 0.0))
