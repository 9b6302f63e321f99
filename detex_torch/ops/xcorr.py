"""
Batched FFT normalized cross-correlation of template waveforms.

Namesake of detex_tpu/ops/xcorr.py: the all-pairs correlation behind
createCluster (reference _makeDFcclags, construct.py:369-394, and _CCX2,
:425-466) and the sliding normalized correlation of cluster validation
(fast_normcorr, :469-483), in ``torch.fft`` and plain torch ops on the
caller's device (the card unless ``device="cpu"``). detex_tpu has no Pallas
kernel here, so neither has the port.

Semantics kept from the reference, as detex_tpu keeps them:
  - full-lag correlation c1 = [c[-(n-1):], c[:n]] (lags -(n-1)..(n-1));
  - only channel-aligned lags ``[nc-1::nc]``, so multiplexed channels are
    never mixed (construct.py:452);
  - edge truncation ``trunc = n // (2*nc) - 1`` lags on both ends;
  - normalization by the window's population std and the template's;
  - values outside [-1, 1] (infs from zeroed windows) set to 0;
  - a pair whose curve is all NaN gives (cc, lag, subsample) = (0, 0, 0);
  - integer lag (argmax + 1 + trunc) * nc - n, the argmax taking the first
    of tied maxima.

Two pair paths, as in detex_tpu. When n % nc == 0 the polyphase path
correlates per channel: the channel-aligned lags of the multiplexed
correlation are exactly the channel sum of the per-channel correlations,
so each pair needs one inverse transform of fft_len_for(n // nc) points
instead of fft_len_for(n). Otherwise the full path correlates the
multiplexed traces and strides the result.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from detex_torch.ops.rolling import rolling_mean_var, rolling_sum_rows
from detex_torch.ops.subsample import subsample_shift

# pairs correlated per inverse transform
PAIR_BATCH = 2048


def next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def fft_len_for(n):
    """Reference FFT length: 2^bit_length(2n) (construct.py:672-674)."""
    return 2 ** int(2 * int(n)).bit_length()


def _pair_tail(c1s, a_j, b_j, sum_i, std_i, n, nc):
    """Shared tail of both pair paths, on channel-aligned lags: c1s [P, K]
    the correlations, a_j / b_j [P, K] the rolling mean and population std
    of event j's windows there, sum_i / std_i [P] event i's. Returns
    (maxcc, lag, subsample) [P] tensors."""
    trunc = n // (2 * nc) - 1
    denom = n * b_j * std_i[:, None]
    nan = torch.full_like(denom, float("nan"))
    result = (c1s - sum_i[:, None] * a_j) / torch.where(denom == 0, nan,
                                                        denom)
    if trunc > 0:
        result = result[:, trunc:-trunc]
    bad = (result > 1.0) | (result < -1.0)
    result = torch.where(bad, torch.zeros_like(result), result)
    isnan = torch.isnan(result)
    allnan = isnan.all(dim=1)
    safe = torch.where(isnan, torch.full_like(result, float("-inf")), result)
    maxind = safe.argmax(dim=1)
    zero = torch.zeros_like(sum_i)
    maxcc = torch.where(allnan, zero, safe.gather(1, maxind[:, None])[:, 0])
    lag = torch.where(allnan, torch.zeros_like(maxind),
                      (maxind + 1 + trunc) * nc - n)
    subs = torch.where(allnan, zero,
                       subsample_shift(torch.nan_to_num(result), maxind))
    return maxcc, lag, subs


def _all_pairs_demux(X, II, JJ, n, nc, nfft2, pair_batch):
    """Polyphase all-pairs correlation (n % nc == 0): per-channel spectra,
    window statistics of the (n_c - 1)-zero-padded channels summed over
    channels (the multiplexed window statistics at channel-aligned
    offsets), then per batch of pairs the channel-summed cross-spectrum,
    one inverse transform and the tail."""
    N = X.shape[0]
    n_c = n // nc
    Xc = X.reshape(N, n_c, nc).transpose(1, 2)            # [N, nc, n_c]
    Fc = torch.fft.rfft(Xc, nfft2, dim=-1)                # [N, nc, R2]
    sums = X.sum(dim=-1)
    stds = X.std(dim=-1, unbiased=False)
    padc = F.pad(Xc, (n_c - 1, n_c - 1))
    S1 = rolling_sum_rows(padc, n_c).sum(dim=1)           # [N, 2*n_c-1]
    S2 = rolling_sum_rows(padc.double() ** 2, n_c).sum(dim=1)
    a = S1 / n
    b = torch.sqrt((S2 / n - a * a).clamp(min=0.0))
    a, b = a.to(X.dtype), b.to(X.dtype)
    out = []
    for s in range(0, len(II), pair_batch):
        ii, jj = II[s:s + pair_batch], JJ[s:s + pair_batch]
        spec = torch.conj(Fc[ii, 0]) * Fc[jj, 0]
        for c in range(1, nc):
            spec += torch.conj(Fc[ii, c]) * Fc[jj, c]
        c = torch.fft.irfft(spec, nfft2, dim=-1)
        del spec
        c1s = torch.cat([c[:, nfft2 - (n_c - 1):], c[:, :n_c]], dim=1)
        del c
        out.append(_pair_tail(c1s, a[jj], b[jj], sums[ii], stds[ii], n, nc))
    return out


def _all_pairs_full(X, II, JJ, n, nc, nfft, pair_batch):
    """All-pairs correlation of the multiplexed traces (n % nc != 0): the
    full-lag curve of each pair strided to channel-aligned lags, then the
    tail."""
    Fx = torch.fft.rfft(X, nfft, dim=-1)
    sums = X.sum(dim=-1)
    stds = X.std(dim=-1, unbiased=False)
    mu, var = rolling_mean_var(F.pad(X, (n - 1, n - 1)), n)  # [N, 2n-1]
    a = mu[:, nc - 1::nc].to(X.dtype)
    b = torch.sqrt(var[:, nc - 1::nc]).to(X.dtype)
    out = []
    for s in range(0, len(II), pair_batch):
        ii, jj = II[s:s + pair_batch], JJ[s:s + pair_batch]
        c = torch.fft.irfft(torch.conj(Fx[ii]) * Fx[jj], nfft, dim=-1)
        c1 = torch.cat([c[:, nfft - (n - 1):], c[:, :n]], dim=1)
        del c
        out.append(_pair_tail(c1[:, nc - 1::nc], a[jj], b[jj], sums[ii],
                              stds[ii], n, nc))
    return out


def xcorr_all_pairs(X, nc, nfft=None, pair_batch=PAIR_BATCH,
                    dtype=torch.float32, device="cuda"):
    """All-pairs normalized cross-correlation of multiplexed, equal-length
    event waveforms X [N, n] (host numpy) with ``nc`` interleaved
    channels, in ``dtype`` (float32, or float64) on ``device``. The full
    path transforms at ``nfft`` (default the reference's fft_len_for(n)),
    the polyphase path at fft_len_for(n // nc) whatever ``nfft`` is, as in
    detex_tpu; ``pair_batch`` pairs share one inverse transform.

    Returns (cc, lag, subsamp) [N, N] numpy float64: the upper triangle
    (i < j) filled, the rest NaN (cc, subsamp) or 0 (lag), as detex_tpu's
    square matrices hold them."""
    X = np.asarray(X)
    N, n = X.shape
    iu, ju = np.triu_indices(N, k=1)
    cc = np.full((N, N), np.nan)
    lag = np.zeros((N, N))
    sub = np.full((N, N), np.nan)
    if len(iu) == 0:
        return cc, lag, sub
    Xd = torch.as_tensor(X, dtype=dtype, device=device)
    II = torch.as_tensor(iu, device=device)
    JJ = torch.as_tensor(ju, device=device)
    if n % nc == 0:
        parts = _all_pairs_demux(Xd, II, JJ, int(n), int(nc),
                                 fft_len_for(n // nc), int(pair_batch))
    else:
        parts = _all_pairs_full(Xd, II, JJ, int(n), int(nc),
                                fft_len_for(n) if nfft is None
                                else int(nfft), int(pair_batch))
    mx, lg, sb = (torch.cat(p).cpu().numpy() for p in zip(*parts))
    cc[iu, ju] = mx
    lag[iu, ju] = lg
    sub[iu, ju] = sb
    return cc, lag, sub


def ccx2(mptd1, mptd2, nc, nfft=None, dtype=torch.float32, device="cuda"):
    """Max cc, integer lag and subsample shift of one pair (the reference's
    _CCX2, construct.py:425-466); ``nfft`` and ``dtype`` as in
    xcorr_all_pairs."""
    X = np.stack([np.asarray(mptd1), np.asarray(mptd2)])
    cc, lag, sub = xcorr_all_pairs(X, nc, nfft=nfft, dtype=dtype,
                                   device=device)
    return cc[0, 1], lag[0, 1], sub[0, 1]


def normcorr_bank(T, s, device="cuda"):
    """Sliding normalized correlation ('valid' mode) of templates T [K, n]
    against one series s [L], in float32 on ``device``: numpy
    [K, L - n + 1]."""
    T = torch.as_tensor(np.asarray(T), dtype=torch.float32, device=device)
    s = torch.as_tensor(np.asarray(s), dtype=torch.float32, device=device)
    K, n = T.shape
    L = s.shape[0]
    nfft = next_pow2(L + n)
    outlen = L - n + 1
    NT = (T - T.mean(dim=1, keepdim=True)) / \
        (T.std(dim=1, unbiased=False, keepdim=True) * n)
    mu, var = rolling_mean_var(s, n)
    a = mu.to(torch.float32)
    b = torch.sqrt(var).to(torch.float32)
    c = torch.fft.irfft(torch.conj(torch.fft.rfft(NT, nfft, dim=-1))
                        * torch.fft.rfft(s, nfft)[None], nfft,
                        dim=-1)[:, :outlen]
    out = (c - NT.sum(dim=1, keepdim=True) * a[None]) / \
        torch.where(b == 0, torch.full_like(b, float("nan")), b)[None]
    return out.cpu().numpy()


def normcorr(t, s, device="cuda"):
    """Normalized sliding correlation of template ``t`` against series
    ``s`` (reference fast_normcorr, construct.py:469-483, including the
    swap when t is longer than s): numpy [len(s) - len(t) + 1]."""
    t = np.asarray(t)
    s = np.asarray(s)
    if len(t) > len(s):
        t, s = s, t
    return normcorr_bank(t[None, :], s, device=device)[0]
