"""
Plain float64 reference of the answers of a detection run: the samples a
chunk holds, its band-pass, the detection statistic (DS), the triggers,
their STA/LTA values, the magnitudes and the DS histograms.

It works everything out again from the raw samples and the detectors that
the benchmark generated, with numpy, scipy and plain torch (float64, on
whatever device it is given). It imports nothing of the program under test.

Frozen copies, each named where it sits: the DS formula and the trigger
extraction of chip_smoke.py's float64 oracle (``ds_numpy``,
``extract_triggers_np``), the centred STA/LTA with its edge fill, and the
magnitude estimates of Chambers et al. (2015) as Detex states them.

``prec`` selects the precision of every stage boundary: "float64" for the
reference, "bfloat16" for the control, which rounds the raw samples, the
filtered chunk, the DS and the data the magnitudes read to bfloat16.
"""
from __future__ import annotations

import numpy as np
import scipy.signal as sig
import torch

BUFF_SECONDS = 20.0           # trigger suppression half-window (Detex)
LTA_SECONDS = 5.0             # DS STA/LTA windows of SubSpace.detex's
STA_SECONDS = 0.0             # defaults (triggerLTATime, triggerSTATime)
MAX_TRIGGERS = 4096
HIST_EDGES = np.linspace(0.0, 1.0, 401)


def rounded(x, prec):
    """``x`` (numpy) as float64 after rounding to ``prec``."""
    x = np.asarray(x, np.float64)
    if prec == "float64":
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return t.to(torch.float64).numpy()


def rounded_t(x, prec):
    if prec == "float64":
        return x
    return x.to(torch.bfloat16).to(torch.float64)


def bandpass_sos(filt, sr):
    """Second-order sections of the Butterworth band-pass ``filt`` =
    [freqmin, freqmax, corners, zerophase] at ``sr`` (obspy's design)."""
    nyq = 0.5 * sr
    high = min(filt[1] / nyq, 1.0 - 1e-6)
    return sig.iirfilter(int(filt[2]), [filt[0] / nyq, high], btype="band",
                         ftype="butter", output="sos")


def detrend(x):
    """Each row of x with its least-squares line removed."""
    x = np.asarray(x, np.float64)
    i = np.arange(x.shape[-1], dtype=np.float64)
    i -= i.mean()
    b = (x @ i) / (i @ i)
    return x - x.mean(-1, keepdims=True) - b[..., None] * i


def host_prep(raw, sr, filt, prec="float64"):
    """A chunk [nc, L] as the host filter leaves it: a least-squares line
    removed from each channel, then the band-pass run forward and, for a
    zero-phase filter, again over the reversed signal, with no padding."""
    x = detrend(rounded(raw, prec))
    if filt:
        sos = bandpass_sos(filt, sr)
        x = sig.sosfilt(sos, x, axis=-1)
        if filt[3]:
            x = sig.sosfilt(sos, x[:, ::-1], axis=-1)[:, ::-1]
    return rounded(np.ascontiguousarray(x), prec)


_POWER = {}


def zerophase_power(filt, sr, nfft):
    """|H|^2 of the band-pass at the rfft bins of ``nfft``, the angular
    frequencies 2 pi k / nfft (the response of a forward and a reversed
    pass)."""
    key = (tuple(filt), float(sr), int(nfft))
    if key not in _POWER:
        w = 2.0 * np.pi * np.arange(nfft // 2 + 1) / nfft
        _, h = sig.sosfreqz(bandpass_sos(filt, sr), worN=w)
        _POWER.clear()
        _POWER[key] = (h * np.conj(h)).real
    return _POWER[key]


def device_prep(raw, sr, filt, device, prec="float64"):
    """Chunks [B, nc, L] as the device filter defines them: a least-squares
    line removed from each channel, then the zero-phase band-pass applied
    as a linear convolution with the response |H|^2 (zero padding, no
    wrap). torch float64 on ``device``."""
    x = rounded_t(torch.as_tensor(raw, device=device).to(torch.float64),
                  prec)
    L = x.shape[-1]
    i = torch.arange(L, dtype=torch.float64, device=device)
    ic = i - i.mean()
    b = (x * ic).sum(-1, keepdim=True) / (ic * ic).sum()
    x = x - x.mean(-1, keepdim=True) - b * ic
    if filt:
        nfft = 1 << int(2 * L - 1).bit_length()
        H = torch.as_tensor(zerophase_power(filt, sr, nfft), device=device)
        x = torch.fft.irfft(torch.fft.rfft(x, nfft) * H, nfft)[..., :L]
    return rounded_t(x, prec)


def multiplex(x):
    """Interleave the channels of [..., nc, L] into [..., L * nc]."""
    if isinstance(x, torch.Tensor):
        return x.transpose(-1, -2).reshape(*x.shape[:-2], -1)
    return np.ascontiguousarray(np.asarray(x).T).reshape(-1)


class Bank(object):
    """The reversed basis spectra of detectors on ``device`` for chunks of
    ``Lc`` multiplexed samples (one FFT length for every detector of one
    template length)."""

    def __init__(self, Us, Lc, device):
        self.n = Us[0].shape[1]
        self.nfft = 1 << int(Lc).bit_length()
        self.rows = [u.shape[0] for u in Us]
        U = torch.as_tensor(np.concatenate(Us), dtype=torch.float64,
                            device=device)
        self.Ufd = torch.fft.rfft(U.flip(-1), self.nfft)
        self.sum_u = U.sum(-1)


def ds_rows(x, bank, nc, prec="float64"):
    """DS of every detector of ``bank`` on multiplexed chunks x [B, Lc]
    (torch float64): [B, S, (Lc - n) // nc + 1]. Frozen copy of the
    float64 oracle ds_numpy of chip_smoke.py, batched: the sample variance
    of each window times n under sum_d (u_d . x - sum(u_d) mean(x))^2."""
    n = bank.n
    Lc = x.shape[-1]
    z = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    c = torch.cat([z, x.cumsum(-1)], -1)
    c2 = torch.cat([z, (x * x).cumsum(-1)], -1)
    rsum = c[..., n:] - c[..., :-n]
    rsum2 = c2[..., n:] - c2[..., :-n]
    a = rsum / n
    power = (rsum2 - rsum * rsum / n) / (n - 1) * n
    xfd = torch.fft.rfft(x, bank.nfft)
    out = []
    r0 = 0
    for D in bank.rows:
        cc = torch.fft.irfft(bank.Ufd[None, r0:r0 + D] * xfd[:, None],
                             bank.nfft)[..., n - 1:Lc]
        y = cc - bank.sum_u[r0:r0 + D, None] * a[:, None]
        out.append(((y * y).sum(1) / power)[:, ::nc])
        r0 += D
    return rounded_t(torch.stack(out, 1), prec)


def triggers(ds, threshold, buff):
    """Trigger indices of one DS row: while the row's maximum is at least
    the threshold, take its first argmax and zero the suppressed interval
    around it. Frozen copy of extract_triggers_np (chip_smoke.py's
    oracle)."""
    c = np.array(ds, dtype=np.float64, copy=True)
    L = len(c)
    out = []
    while len(out) < MAX_TRIGGERS and L and np.max(c) >= threshold:
        i = int(np.argmax(c))
        out.append(i)
        if i < buff + 1:
            lo, hi = 0, i + buff
        elif i > L - buff:
            lo, hi = i - buff, L
        else:
            lo, hi = i - buff, i + buff
        c[lo:hi] = 0.0
    return np.asarray(out, np.int64)


def _centered_mean(x, n):
    c = np.cumsum(np.insert(x, 0, 0.0))
    mu = (c[n:] - c[:-n]) / n
    out = np.full(len(x), np.nan)
    start = (n - 1) - ((n - 1) // 2)
    out[start:start + len(mu)] = mu
    return out


def _fill_edges(arr):
    ind = np.where(~np.isnan(arr))[0]
    if len(ind) == 0:
        return arr
    first, last = ind[0], ind[-1]
    arr[:first] = arr[min(first + 1, len(arr) - 1)]
    arr[last + 1:] = arr[last]
    return arr


def stalta(ds, sr):
    """Centred STA/LTA of a DS row with Detex's NaN edge fill (an STA
    window of 0 or 1 sample is |DS| itself)."""
    ab = np.abs(np.asarray(ds, np.float64))
    sta = max(int(STA_SECONDS * sr), 0) or 1
    lta = max(int(LTA_SECONDS * sr), 1)
    sta_arr = ab if sta <= 1 else _centered_mean(ab, sta)
    return _fill_edges(sta_arr.copy()) / _fill_edges(_centered_mean(ab, lta))


def rolling_std(x, win):
    """Trailing rolling sample standard deviation (ddof 1)."""
    c = np.cumsum(np.insert(x, 0, 0.0))
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    s = c[win:] - c[:-win]
    s2 = c2[win:] - c2[:-win]
    return np.sqrt(np.maximum(s2 - s * s / win, 0.0) / (win - 1))


def magnitudes(det, mp, t, nc, issubspace):
    """(Mag, SNR, ProEnMag) of a trigger at DS index ``t`` of detector
    ``det`` on the multiplexed filtered chunk ``mp`` (float64): the
    standard-deviation and projected-energy magnitudes weighted by the
    squared correlation with each training event (Chambers et al. 2015),
    and the SNR against the median trailing noise level before it."""
    U = np.asarray(det["U"], np.float64)
    W = np.asarray(det["WFs"], np.float64)
    mags = np.asarray(det["mags"], np.float64)
    WFU = W @ U.T @ U
    n = WFU.shape[1]
    cd = mp[t * nc:t * nc + n]
    if len(cd) < n:
        return np.nan, np.nan, np.nan
    if t * nc > 5 * n:
        pe = mp[t * nc - 5 * n:t * nc]
    else:
        pe = mp[t * nc:t * nc + 7 * n]
    rs = rolling_std(pe, n) if len(pe) >= n else np.zeros(0)
    base = np.median(rs) if len(rs) else np.nan
    snr = np.std(cd) / base if base else np.nan
    if issubspace:
        proEn = np.var(U.T @ (U @ cd)) / np.var(WFU, axis=1)
        NT = ((W - W.mean(1, keepdims=True)) /
              (W.std(1, keepdims=True) * W.shape[1]))
        cors = (NT @ cd - NT.sum(1) * cd.mean()) / cd.std()
        use = mags > -15
        w = np.square(cors)[use]
        pe_mag = float(np.sum((mags[use] + np.log10(np.sqrt(proEn[use]))) * w)
                       / np.sum(w))
        st_mag = float(np.sum((mags[use] + np.log10(
            np.std(cd) / np.std(W, axis=1)[use])) * w) / np.sum(w))
        return st_mag, snr, pe_mag
    pe_mag = mags[0] + np.dot(cd, WFU[0]) / np.dot(WFU[0], WFU[0])
    st_mag = mags[0] + np.log10(np.std(cd) / np.std(WFU[0]))
    return float(st_mag), snr, float(pe_mag)


def histogram(ds):
    """Counts of a DS row in Detex's 400 uniform bins on [0, 1]."""
    return np.histogram(np.asarray(ds), bins=HIST_EDGES)[0]
