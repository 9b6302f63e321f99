"""
ctypes binding of the native host library (the repository's
native/detex_host.cpp).

Namesake of detex_tpu/native.py. The library is built with g++ at first
use, with detex_tpu's flags (``-O3 -shared -fPIC``, nothing that changes
the arithmetic), so that both packages get the same bits from the same
source; it goes into the port's own build directory
(detex_torch/kernels/_build/) under a digest of the source and flags,
written to a temporary name and renamed into place, so that processes
building at once never load a half-written file. detex_tpu's
native/libdetex_host.so is never touched. ``available()`` says whether the
library built and has ABI version 3.

Without the library the filters, the detrend, the interleave and the
rolling std fall back to numpy / scipy, as detex_tpu's do; the miniSEED
record decoder and the STEIM encoders raise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

ABI_VERSION = 3
SOURCE = Path(__file__).resolve().parent.parent / "native" / "detex_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "kernels" / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_TRIED = False


def library_path(source=SOURCE, stem="libdetex_host"):
    """Where the library of ``source`` (this module's by default) and these
    flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / ("%s_%s.so" % (stem, h.hexdigest()[:16]))


def _build(so, source=SOURCE):
    """g++ into a name of this process, then an atomic rename."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("%s.%d.tmp" % (so.stem, os.getpid()))
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(source), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.is_file():
        return None
    so = library_path()
    try:
        if not so.is_file():
            _build(so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    u8ptr = ctypes.POINTER(ctypes.c_uint8)
    i32ptr = ctypes.POINTER(ctypes.c_int32)
    lib.detex_sosfilt.argtypes = [dptr, ctypes.c_int, dptr, ctypes.c_int64,
                                  ctypes.c_int]
    lib.detex_detrend_linear.argtypes = [dptr, ctypes.c_int64]
    lib.detex_interleave.argtypes = [dptr, ctypes.c_int, ctypes.c_int64,
                                     dptr]
    lib.detex_prep_chunk.argtypes = [dptr, ctypes.c_int, ctypes.c_int64,
                                     dptr, ctypes.c_int, ctypes.c_int, dptr]
    lib.detex_prep_chunk.restype = ctypes.c_int
    lib.detex_rolling_std.argtypes = [dptr, ctypes.c_int64, ctypes.c_int64,
                                      dptr]
    lib.detex_mseed_record.argtypes = [
        u8ptr, ctypes.c_int64, ctypes.c_char_p, dptr, dptr, i32ptr, dptr,
        ctypes.c_int64]
    lib.detex_mseed_record.restype = ctypes.c_int
    for enc in (lib.detex_steim1_encode, lib.detex_steim2_encode):
        enc.argtypes = [i32ptr, ctypes.c_int64, u8ptr, ctypes.c_int]
        enc.restype = ctypes.c_int
    lib.detex_abi_version.restype = ctypes.c_int
    if lib.detex_abi_version() != ABI_VERSION:
        return None
    _LIB = lib
    return _LIB


def available():
    """True when the library is built and loaded with ABI version 3."""
    return _load() is not None


def _as_c(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _require(what):
    lib = _load()
    if lib is None:
        raise IOError("native host library unavailable (g++ could not build "
                      "%s) for %s" % (SOURCE, what))
    return lib


def sosfilt(sos, data, zerophase=False):
    """SOS filter of ``data`` (a new float64 array), forward and, with
    ``zerophase``, again over the reversed signal without padding;
    scipy.signal.sosfilt's arithmetic."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64).copy()
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    if lib is None:
        from scipy import signal as _sig
        out = _sig.sosfilt(sos, data)
        if zerophase:
            out = _sig.sosfilt(sos, out[::-1])[::-1]
        return out
    lib.detex_sosfilt(_as_c(sos), sos.shape[0], _as_c(data), len(data),
                      1 if zerophase else 0)
    return data


def detrend_linear(data):
    """``data`` less its least-squares line (a new float64 array)."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.float64).copy()
    if lib is None:
        from scipy import signal as _sig
        return _sig.detrend(data, type="linear")
    lib.detex_detrend_linear(_as_c(data), len(data))
    return data


def interleave(chans):
    """Multiplex a [nc, n] channel stack (flatten in Fortran order)."""
    lib = _load()
    chans = np.ascontiguousarray(chans, dtype=np.float64)
    if lib is None:
        return chans.flatten(order="F")
    nc, n = chans.shape
    out = np.empty(nc * n, dtype=np.float64)
    lib.detex_interleave(_as_c(chans), nc, n, _as_c(out))
    return out


def prep_chunk(chans, sos=None, zerophase=True):
    """Detrend, bandpass (``sos``, optional) and interleave a [nc, n]
    chunk in one pass."""
    lib = _load()
    chans = np.ascontiguousarray(chans, dtype=np.float64).copy()
    nc, n = chans.shape
    if lib is None:
        from scipy import signal as _sig
        for c in range(nc):
            chans[c] = _sig.detrend(chans[c], type="linear")
            if sos is not None:
                y = _sig.sosfilt(sos, chans[c])
                if zerophase:
                    y = _sig.sosfilt(sos, y[::-1])[::-1]
                chans[c] = y
        return chans.flatten(order="F")
    out = np.empty(nc * n, dtype=np.float64)
    if sos is None:
        sosarr = np.zeros((0, 6))
        nsec = 0
    else:
        sosarr = np.ascontiguousarray(sos, dtype=np.float64)
        nsec = sosarr.shape[0]
    lib.detex_prep_chunk(_as_c(chans), nc, n, _as_c(sosarr), nsec,
                         1 if zerophase else 0, _as_c(out))
    return out


def rolling_std(x, win):
    """Trailing rolling sample std (ddof 1), length len(x) - win + 1."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    if lib is None or len(x) < win or win < 2:
        from detex_torch.ops.rolling import rolling_std as _np_rolling_std
        return _np_rolling_std(x, win)
    out = np.empty(len(x) - win + 1, dtype=np.float64)
    lib.detex_rolling_std(_as_c(x), len(x), win, _as_c(out))
    return out


def mseed_record(buf, offset, scratch=None):
    """Decode one miniSEED record of ``buf`` at ``offset``: (reclen, id, t0,
    sr, samples float64). ``samples`` is empty for a record to skip (an
    encoding the decoder does not take, such as ASCII log channels, or a
    corrupt payload); IOError when the header cannot be parsed. ``scratch``
    is an optional reusable float64 buffer of at least 65536 samples."""
    lib = _require("miniSEED decoding")
    mv = np.frombuffer(buf, dtype=np.uint8, count=len(buf) - offset,
                       offset=offset)
    ident = ctypes.create_string_buffer(24)
    t0 = ctypes.c_double()
    sr = ctypes.c_double()
    ns = ctypes.c_int32()
    out = scratch if scratch is not None else np.empty(65536, np.float64)
    rc = lib.detex_mseed_record(
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(mv),
        ident, ctypes.byref(t0), ctypes.byref(sr), ctypes.byref(ns),
        _as_c(out), len(out))
    if rc <= 0:
        raise IOError("miniSEED record decode failed (code %d) at offset %d"
                      % (rc, offset))
    n = int(ns.value)
    samples = out[:n].copy() if n > 0 else np.empty(0, np.float64)
    return rc, ident.value.decode(), t0.value, sr.value, samples


def _steim(fn, samples, nframes):
    x = np.ascontiguousarray(samples, dtype=np.int32)
    out = np.zeros(nframes * 64, np.uint8)
    got = fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(x),
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nframes)
    return int(got), out.tobytes()


def steim1_encode(samples, nframes):
    """STEIM1-encode int32 ``samples`` into ``nframes`` 64-byte frames:
    (samples encoded, frame bytes)."""
    return _steim(_require("miniSEED encoding").detex_steim1_encode,
                  samples, nframes)


def steim2_encode(samples, nframes):
    """STEIM2-encode int32 ``samples`` into ``nframes`` 64-byte frames:
    (samples encoded, frame bytes). ValueError when a sample-to-sample
    difference exceeds STEIM2's 30 bits."""
    got, frames = _steim(_require("miniSEED encoding").detex_steim2_encode,
                         samples, nframes)
    if got < 0:
        raise ValueError("STEIM2 cannot encode a sample-to-sample "
                         "difference beyond 30 bits; use STEIM1")
    return got, frames
