"""
Device preprocessing of raw channel chunks (``devicePrep``).

Namesake of detex_tpu/ops/prep.py. The reference filters and detrends each
chunk on the host (obspy bandpass + detrend + multiplex, construct.py
990-1030); here the same preprocessing runs on the chunk's device inside
the transforms the scan needs:

  - linear detrend: a least-squares line per channel fit on the valid
    samples (a zero-padded chunk's pad is excluded and zeroed);
  - Butterworth bandpass: the channel spectra times the filter's response
    at the rfft bins (|H|^2, the zero-phase forward+reverse pass, or the
    complex one-pass H);
  - decimation by ``dec``: the spectra truncated at the decimated Nyquist,
    an ideal anti-alias lowpass plus a spectral resample.

Two forms, as in detex_tpu:

  prep_multiplex_batch  the filtered channels of a batch, multiplexed, for
                        any scan (parallel/scan.scan_chunks_raw on an
                        overlap-save bank);
  ds_bank_demux_raw     the DS of one chunk on a full-length demuxed bank,
                        standardized over the valid region, the
                        cross-correlation corrected algebraically from the
                        unstandardized spectra, then the ds_finalize kernel
                        (scan_chunks_raw's "raw-demux" route, run_bank_raw).

The filter response is computed with scipy on the host in float64. Every
inverse of a truncated or filtered spectrum goes through dft.irfft_full,
which zeroes the imaginary parts of its end bins (ROADMAP C24).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import signal as _sig

from detex_torch.ops import cuda_kernels as _ck
from detex_torch.ops import dft as _dft
from detex_torch.ops import ds as _ds
from detex_torch.ops.rolling import window_stats_rows


def butter_response(filt, sr, nfft, zerophase=True, device="cuda"):
    """Frequency response (length nfft//2 + 1) of the obspy-style
    Butterworth bandpass ``filt`` = [freqmin, freqmax, corners, zerophase]
    at the rfft bins of ``nfft`` at sampling rate ``sr``, computed with
    scipy in float64: float32 |H|^2 (zero phase, a forward+reverse pass)
    when ``zerophase``, else the complex64 one-pass H, on ``device``."""
    freqmin, freqmax, corners = filt[0], filt[1], int(filt[2])
    nyq = 0.5 * sr
    low = freqmin / nyq
    high = min(freqmax / nyq, 1.0 - 1e-6)
    sos = _sig.iirfilter(corners, [low, high], btype="band", ftype="butter",
                         output="sos")
    _, h = _sig.sosfreqz(sos, worN=nfft // 2 + 1, whole=False)
    if zerophase:
        return torch.as_tensor((h * np.conj(h)).real.astype(np.float32),
                               device=device)
    return torch.as_tensor(h.astype(np.complex64), device=device)


def _masked_detrend(xc, Lv):
    """Linear detrend of every channel of xc [..., nc, L] fit on its first
    ``Lv`` samples (the valid region; Lv [...] int, one per chunk) and
    applied there, zero past them. The fit runs in float64 (detex_tpu fits
    in float32); the result is float32."""
    L = xc.shape[-1]
    i = torch.arange(L, dtype=torch.float64, device=xc.device)
    Lv = torch.as_tensor(Lv, dtype=torch.float64, device=xc.device)
    w = (i < Lv[..., None, None]).to(torch.float64)          # [..., 1, L]
    x = xc.to(torch.float64)
    nn = w.sum(dim=-1)
    st = (w * i).sum(dim=-1)
    stt = (w * i * i).sum(dim=-1)
    sy = (x * w).sum(dim=-1)
    sty = (x * w * i).sum(dim=-1)
    det = nn * stt - st * st
    det = torch.where(det == 0, torch.ones_like(det), det)   # empty chunks
    nn = nn.clamp(min=1.0)
    b = (nn * sty - st * sy) / det
    a = (sy - b * st) / nn
    return ((x - a[..., None] - b[..., None] * i) * w).to(torch.float32)


def _filtered_spectra(xd, H, nfftp, dec):
    """rfft of the detrended channels at dec * nfftp, times H, truncated to
    nfftp//2 + 1 bins when dec > 1: a fresh complex64 tensor."""
    Ff = torch.fft.rfft(xd, dec * nfftp, dim=-1) * H
    if dec > 1:
        Ff = Ff[..., :nfftp // 2 + 1].contiguous()
    return Ff


def prep_multiplex_batch(Xc, LV, H, nfftp, dec, nc):
    """Device prep of a raw chunk batch for any scan: Xc [B, nc, L_raw]
    float32 (zero-padded rows), LV [B] true per-channel raw sample counts,
    H the response over dec*nfftp bins (butter_response), nfftp the
    per-channel FFT length at the decimated rate (>= L_c + n_c, as the
    demuxed banks compute it). Returns (X [B, L_c*nc] multiplexed filtered
    channels with the pad zeroed, lens [B] valid multiplexed sample counts
    as a list), L_c = L_raw // dec. No standardization: every scan
    standardizes its chunks itself."""
    B, nch, L_raw = Xc.shape
    if nch != nc:
        raise ValueError("Xc has %d channels, expected nc=%d" % (nch, nc))
    L_c = L_raw // dec
    LV = [int(v) for v in LV]
    xd = _masked_detrend(Xc, LV)
    Ff = _filtered_spectra(xd, H, nfftp, dec)
    del xd
    xf = _dft.irfft_full(Ff, nfftp)[..., :L_c]
    del Ff
    LVd = [v // dec for v in LV]
    i = torch.arange(L_c, device=Xc.device)
    w = i[None, :] < torch.as_tensor(LVd, device=Xc.device)[:, None]
    # zero the pad: filter ringing past the valid samples would otherwise
    # reach the (masked) pad windows' stats
    xf = torch.where(w[:, None, :], xf, torch.zeros_like(xf))
    X = xf.transpose(1, 2).reshape(B, L_c * nch)
    return X, [v * nch for v in LVd]


def ds_bank_demux_raw(xc, Lv, H, Ufd2, sum_u, d_mask, n_c, nc, nfft2, dec=1):
    """DS of one chunk from raw channels with the preprocessing fused in:
    xc [nc, L_raw] float32 zero-padded to dec x the bank's per-channel
    length, Lv (int) its true raw sample count, H the response over
    dec*nfft2 bins, the arrays of a full-length demuxed bank. Returns
    [S, L_c - n_c + 1] at the decimated rate (the caller masks windows past
    Lv // dec).

    The filtered channels are standardized over the valid region only, with
    a 1e-30 variance floor; the cross-correlation comes from the
    unstandardized filtered spectra and is corrected algebraically,
    cc_std = (cc - mu * sum_u) / sd (detex_tpu prep.py:100-117); then one
    ds_finalize launch on the card."""
    L_c = xc.shape[1] // dec
    Lvd = int(Lv) // dec
    Ff = _filtered_spectra(_masked_detrend(xc, int(Lv)), H, nfft2, dec)
    # irfft_full zeroes Ff's end bins' imaginary parts in place; that is
    # safe for the cross-spectra below: Ufd2's bins 0 and nfft2/2 are real,
    # so only their imaginary parts change, and irfft_full zeroes those too
    xf = _dft.irfft_full(Ff, nfft2)[:, :L_c]
    w = (torch.arange(L_c, device=xc.device) < Lvd)[None, :]
    cnt = float(max(Lvd, 0) * nc)
    xf64 = torch.where(w, xf, torch.zeros_like(xf)).to(torch.float64)
    mu = xf64.sum() / cnt
    var = (torch.where(w, xf64 - mu, torch.zeros_like(xf64)) ** 2).sum() / cnt
    sd = torch.sqrt(var.clamp(min=1e-30))
    xs = torch.where(w, (xf64 - mu) / sd, torch.zeros_like(xf64))
    a, power = window_stats_rows(xs.to(torch.float32)[None], n_c, n_c * nc)
    del xf, xf64, xs
    cc = _dft.irfft_full(_ds.channel_sum(Ufd2, Ff), nfft2)[:, :, n_c - 1:L_c]
    del Ff
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u))
    cc = ((cc - mu.to(torch.float32) * su[:, :, None])
          / sd.to(torch.float32)).contiguous()
    return _ck.ds_finalize(cc, a[0].contiguous(),
                           _ds._safe_power(power[0]).contiguous(),
                           su.contiguous())


def run_bank_raw(chans, bank, nc, H, dec=1):
    """Host wrapper of ds_bank_demux_raw: raw channels [nc, L_raw] (numpy)
    -> numpy DS [S, n_valid] over the windows fully inside the real data, on
    a full-length demuxed bank built at the decimated rate."""
    if _ds.bank_kind(bank) != "demux":
        raise ValueError("run_bank_raw needs a full-length demuxed bank "
                         "(build_bank with prefer_os=False or block_fft=0)")
    chans = np.asarray(chans, np.float32)
    L_pad = (bank["pad_len"] // nc) * dec
    L = min(chans.shape[1], L_pad)
    xp = np.zeros((nc, L_pad), np.float32)
    xp[:, :L] = chans[:, :L]
    dev = bank["sum_u"].device
    out = ds_bank_demux_raw(torch.from_numpy(xp).to(dev), L, H,
                            bank["Ufd2"], bank["sum_u"], bank["d_mask"],
                            bank["n_c"], int(nc), bank["nfft2"], int(dec))
    n_valid = ((L // dec) * nc - bank["n"]) // nc + 1
    return out[:, :max(n_valid, 0)].cpu().numpy()


def prep_numpy(chans, Lv, H, nfftp, dec, nc):
    """float64 numpy oracle of prep_multiplex_batch for one chunk: raw
    channels chans [nc, L_raw], Lv valid raw samples, H the response (any
    array-like) -> multiplexed filtered chunk [L_c * nc] (float64, zero past
    Lv // dec), by the same masked detrend, rfft, H, truncation and irfft."""
    x = np.asarray(chans, np.float64)
    L_raw = x.shape[1]
    L_c = L_raw // dec
    i = np.arange(L_raw, dtype=np.float64)
    w = (i < Lv).astype(np.float64)
    nn, st, stt = w.sum(), (w * i).sum(), (w * i * i).sum()
    sy, sty = (x * w).sum(axis=1), (x * w * i).sum(axis=1)
    det = nn * stt - st * st
    det = det if det != 0 else 1.0
    nn = max(nn, 1.0)
    b = (nn * sty - st * sy) / det
    a = (sy - b * st) / nn
    xd = (x - a[:, None] - b[:, None] * i) * w
    Ff = np.fft.rfft(xd, dec * nfftp, axis=-1) * np.asarray(H, np.complex128)
    xf = np.fft.irfft(Ff[:, :nfftp // 2 + 1], nfftp, axis=-1)[:, :L_c]
    xf[:, Lv // dec:] = 0.0
    return xf.T.reshape(-1)
