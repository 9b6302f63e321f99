"""
ctypes binding of the engine's chunk preparation in one native pass
(detex_torch/kernels/host_prep.cpp).

``prep(chans, sos, zerophase, out_dtype, mux)`` detrends the channels of a
chunk (int32, int64, float32 or float64 views of one common length),
band-passes them with ``sos`` (none when it is None) and writes them as
``out_dtype`` (float32 or float64), multiplexed or as a [nc, n] stack: the
bits of native.detrend_linear, native.sosfilt, the cast and the interleave
one after the other, in one call that reads the input once.

The library is built like native.py's, with g++ and exactly
native.CXX_FLAGS, into native.BUILD_DIR under a digest of the source and
the flags, on a checkout's first use. ``available()`` says whether it
built; without it ``prep`` is not called and the engine takes
construct._applyFilter and construct.multiplex.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from detex_torch import native as _native

ABI_VERSION = 1
SOURCE = Path(__file__).resolve().parent / "kernels" / "host_prep.cpp"
STEM = "libdetex_host_prep"

#: input types by the code host_prep.cpp's detex_host_prep takes
IN_TYPES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1,
            np.dtype(np.float32): 2, np.dtype(np.float64): 3}

_LIB = None
_TRIED = False


def library_path():
    """Where the library of this source and native.CXX_FLAGS is built."""
    return _native.library_path(SOURCE, STEM)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    try:
        if not so.is_file():
            _native._build(so, SOURCE)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.detex_host_prep.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.detex_host_prep.restype = ctypes.c_int
    lib.detex_host_prep_abi_version.restype = ctypes.c_int
    if lib.detex_host_prep_abi_version() != ABI_VERSION:
        return None
    _LIB = lib
    return _LIB


def available():
    """True when the library is built and loaded with ABI version 1."""
    return _load() is not None


def prep(chans, sos, zerophase, out_dtype, mux):
    """The detrended (and, with ``sos``, band-passed) chunk of the 1-D
    contiguous arrays ``chans`` (one type of IN_TYPES, one length of at
    least 2; ValueError otherwise) as ``out_dtype``: multiplexed [n * nc]
    when ``mux``, else a [nc, n] stack. None when a channel holds NaN, for
    more than 16 channels or sections, or when the library is not
    available."""
    nc, n = len(chans), len(chans[0])
    if n < 2 or chans[0].dtype not in IN_TYPES or any(
            c.dtype != chans[0].dtype or c.shape != (n,) or
            not c.flags.c_contiguous for c in chans):
        raise ValueError("prep takes 1-D contiguous channels of one type "
                         "of IN_TYPES and one length of at least 2")
    lib = _load()
    if lib is None:
        return None
    ptrs = (ctypes.c_void_p * nc)(*[c.ctypes.data for c in chans])
    if sos is None:
        sosarr, nsec = np.zeros((0, 6)), 0
    else:
        sosarr = np.ascontiguousarray(sos, dtype=np.float64)
        nsec = sosarr.shape[0]
    out = np.empty(n * nc if mux else (nc, n), dtype=out_dtype)
    rc = lib.detex_host_prep(
        ptrs, IN_TYPES[chans[0].dtype], nc, n,
        sosarr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nsec,
        1 if zerophase else 0, out.ctypes.data,
        1 if out.dtype == np.float32 else 0, 1 if mux else 0)
    if rc != 0:
        return None
    return out
