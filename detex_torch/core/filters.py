"""
Host-side signal conditioning of the detection engine: the obspy-style
Butterworth bandpass, linear detrend and decimation, in float64 with
scipy.signal.

Namesake of detex_tpu/core/filters.py, which runs the bandpass and the
detrend in its native C++ library when that is built and with scipy
otherwise; the port always uses scipy (the same arithmetic as detex_tpu's
scipy path, within rounding of its native one).

zerophase follows obspy: the SOS filter forward, then over the reversed
signal, without padding (not scipy.filtfilt).
"""
from __future__ import annotations

import numpy as np
from scipy import signal as _sig

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
    """Butterworth bandpass, matching obspy.signal.filter.bandpass."""
    return _sosfilt(_bandpass_sos(freqmin, freqmax, sr, corners), data,
                    zerophase)


def lowpass(data, freq, sr, corners=4, zerophase=False):
    sos = _sig.iirfilter(corners, freq / (0.5 * sr), btype="lowpass",
                         ftype="butter", output="sos")
    return _sosfilt(sos, data, zerophase)


def detrend_linear(data):
    """Remove a least-squares line (scipy.signal.detrend)."""
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
