"""
Build the CUDA kernels of detex_torch at first use and bind them with ctypes.

The ``.cu`` sources in this directory are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, cached under ``_build/`` by a digest of the sources and flags. A
build failure raises with nvcc's stderr; there is no fallback.
``torch.utils.cpp_extension`` is not used: it needs ninja, and including
PyTorch's headers makes a build take minutes instead of seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"
SOURCES = ("fwd_prep_fold.cu", "spec_ds_fold.cu", "rfft_ct.cu",
           "irfft_ct.cu", "ds_finalize_os_fold.cu", "rfft_ct_half.cu",
           "ds_finalize_os_scan.cu", "ds_finalize_os.cu", "hist_uniform.cu",
           "ds_finalize.cu")
HEADERS = ("fft.cuh", "fft_regs.cuh", "fwd_prep_fold.cuh",
           "spec_ds_fold.cuh", "rfft_ct.cuh", "irfft_ct.cuh",
           "finalize_os.cuh", "ds_finalize_os_fold.cuh", "rfft_ct_half.cuh",
           "ds_finalize_os_scan.cuh", "ds_finalize_os.cuh",
           "hist_uniform.cuh", "ds_finalize.cuh")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the CUDA toolkit's default install location, searched after $CUDA_HOME
# and PATH
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    # xq, stage, tw, fr, fi, a, power, B, nc, Lp, m, W, D0, pad0, n_c,
    # out_len, Rp, log2m, stream
    "detex_fwd_prep_fold": [_P] * 7 + [_I, _I, _LL, _I, _I, _I, _I, _I, _LL,
                                       _I, _I, _P],
    # ur, ui, fr, fi, a, power, su, nv, stage, tw, ds, pyr, hist, B, S, D,
    # nc, m, W, head, Rp, nbin, sub, log2m, stream
    "detex_spec_ds_fold": [_P] * 13 + [_I] * 11 + [_P],
    # x, stage, tw, out, N, Lp, m, W, log2m, stream
    "detex_rfft_ct": [_P] * 4 + [_LL, _LL, _I, _I, _I, _P],
    # spec, stage, tw, out, N, log2m, stream
    "detex_irfft_ct": [_P] * 4 + [_LL, _I, _P],
    # cb, a, pw, su, nv, ds, pyr, hist, BS, D, m, blk, W, head, group,
    # nbin, stream
    "detex_ds_finalize_os_fold": [_P] * 8 + [_LL] + [_I] * 7 + [_P],
    # x, stage, tw, fr, fi, N, Lp, m, W, Rp, log2m, stream
    "detex_rfft_ct_half": [_P] * 5 + [_LL, _LL, _I, _I, _I, _I, _P],
    # cb, a, pw, su, nv, ds, pyr, hist, S, D, m, blk, W, head, nbin, stream
    "detex_ds_finalize_os_scan": [_P] * 8 + [_LL] + [_I] * 6 + [_P],
    # cb, a, pw, su, ds, S, D, m, blk, W, head, stream
    "detex_ds_finalize_os": [_P] * 5 + [_LL] + [_I] * 5 + [_P],
    # ds, hist, S, L, nbin, stream
    "detex_hist_uniform": [_P] * 2 + [_LL, _LL, _I, _P],
    # cc, a, pw, su, ds, S, D, L, stream
    "detex_ds_finalize": [_P] * 5 + [_LL, _I, _LL, _P],
}

_LIBS = {}


def find_nvcc():
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then NVCC_DEFAULT. Raises
    RuntimeError when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(NVCC_DEFAULT)
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, %s): the CUDA kernels of "
        "detex_torch cannot be built" % NVCC_DEFAULT)


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((KERNEL_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _raise_on_failure(cmd, returncode, stderr):
    if returncode != 0:
        raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                           % (returncode, " ".join(cmd), stderr))


def load_library(build_dir=None):
    """The ctypes handle of the kernel library, built on first use into
    ``build_dir`` (default ``BUILD_DIR``). nvcc's ptxas report (registers,
    shared memory, spills per kernel) is kept beside the library as
    ``<name>.log``."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    key = str(build_dir)
    if key in _LIBS:          # every launch asks: no hashing after the first
        return _LIBS[key]
    so = build_dir / ("libdetex_kernels_%s.so" % _digest())
    if not so.is_file():
        nvcc = find_nvcc()
        build_dir.mkdir(parents=True, exist_ok=True)
        tag = "%s.%d" % (so.stem, os.getpid())
        objs = [build_dir / ("%s.%s.o" % (tag, Path(s).stem))
                for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(KERNEL_DIR / s)]
                for s, o in zip(SOURCES, objs)]
        cmds.append([nvcc, "-shared", "-o", str(build_dir / (tag + ".tmp")),
                     *map(str, objs)])
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds[:-1]]
        outs = [p.communicate() for p in procs]
        log = []
        for cmd, p, (out, err) in zip(cmds, procs, outs):
            _raise_on_failure(cmd, p.returncode, err)
            log.append(out + err)
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        _raise_on_failure(cmds[-1], link.returncode, link.stderr)
        so.with_suffix(".log").write_text("".join(log))
        os.replace(build_dir / (tag + ".tmp"), so)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.detex_cuda_error_string.argtypes = [ctypes.c_int]
    lib.detex_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[key] = lib
    return lib


def check(lib, rc, kernel):
    """Raise with the CUDA error string when a launch returned non-zero."""
    if rc != 0:
        msg = lib.detex_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError("%s launch failed: CUDA error %d (%s)"
                           % (kernel, rc, msg))
