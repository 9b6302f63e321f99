"""
Host-side signal conditioning of the detection engine: the obspy-style
Butterworth bandpass, lowpass and highpass, linear detrend, demean and
decimation, in float64.

Namesake of detex_tpu/core/filters.py: the bandpass and the detrend run in
the native host library (detex_torch.native, the same C++ source and
flags as detex_tpu's, so the same bits) when it is built, and with
scipy.signal otherwise, as detex_tpu's do.

zerophase follows obspy: the SOS filter forward, then over the reversed
signal, without padding (not scipy.filtfilt).
"""
from __future__ import annotations

import numpy as np
from scipy import signal as _sig

from detex_torch import native as _native

_sos_cache = {}


def _bandpass_sos(freqmin, freqmax, sr, corners):
    key = ("bp", float(freqmin), float(freqmax), float(sr), int(corners))
    sos = _sos_cache.get(key)
    if sos is None:
        nyq = 0.5 * sr
        low = freqmin / nyq
        high = freqmax / nyq
        if high >= 1.0:
            high = 1.0 - 1e-6
        sos = _sig.iirfilter(corners, [low, high], btype="band",
                             ftype="butter", output="sos")
        _sos_cache[key] = sos
    return sos


def _sosfilt(sos, data, zerophase):
    out = _sig.sosfilt(sos, np.asarray(data, np.float64))
    if zerophase:
        out = _sig.sosfilt(sos, out[::-1])[::-1]
    return out


def bandpass(data, freqmin, freqmax, sr, corners=4, zerophase=False):
    """Butterworth bandpass, matching obspy.signal.filter.bandpass; the
    native SOS filter when the host library is built."""
    sos = _bandpass_sos(freqmin, freqmax, sr, corners)
    if _native.available():
        return _native.sosfilt(sos, data, zerophase=zerophase)
    return _sosfilt(sos, data, zerophase)


def lowpass(data, freq, sr, corners=4, zerophase=False):
    sos = _sig.iirfilter(corners, freq / (0.5 * sr), btype="lowpass",
                         ftype="butter", output="sos")
    return _sosfilt(sos, data, zerophase)


def highpass(data, freq, sr, corners=4, zerophase=False):
    sos = _sig.iirfilter(corners, freq / (0.5 * sr), btype="highpass",
                         ftype="butter", output="sos")
    return _sosfilt(sos, data, zerophase)


def demean(data):
    data = np.asarray(data)
    return data - data.mean()


def detrend_linear(data):
    """Remove a least-squares line (native when the host library is built,
    else scipy.signal.detrend)."""
    if _native.available():
        return _native.detrend_linear(data)
    return _sig.detrend(np.asarray(data, dtype=np.float64), type="linear")


def decimate(data, factor, sr):
    """Integer decimation: a zero-phase 8-corner lowpass at 40% of the new
    Nyquist, then every ``factor``-th sample (detex_tpu's rule)."""
    factor = int(factor)
    if factor == 1:
        return np.asarray(data)
    new_nyq = 0.5 * sr / factor
    out = lowpass(data, 0.8 * new_nyq, sr, corners=8, zerophase=True)
    return out[::factor]
