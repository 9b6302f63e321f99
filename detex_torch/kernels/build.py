"""
Build the CUDA kernels of detex_torch at first use and bind them with ctypes.

The ``.cu`` sources in this directory are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into one shared library with a
plain C interface, cached under ``_build/`` by a digest of the sources and
flags. A build failure raises with nvcc's stderr; there is no fallback.
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
SOURCES = ("fwd_prep_fold.cu", "spec_ds_fold.cu")
HEADERS = ("fft.cuh", "fwd_prep_fold.cuh", "spec_ds_fold.cuh")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# the CUDA toolkit's default install location, searched after $CUDA_HOME
# and PATH
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    # xq, tw, fr, fi, a, power, B, nc, Lp, m, W, D0, pad0, n_c, out_len,
    # Rp, log2m, stream
    "detex_fwd_prep_fold": [_P] * 6 + [_I, _I, _LL, _I, _I, _I, _I, _I, _LL,
                                       _I, _I, _P],
    # ur, ui, fr, fi, a, power, su, nv, tw, ds, pyr, hist, B, S, D, nc, m,
    # W, head, Rp, nbin, sub, log2m, stream
    "detex_spec_ds_fold": [_P] * 12 + [_I] * 11 + [_P],
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


def load_library(build_dir=None):
    """The ctypes handle of the kernel library, built on first use into
    ``build_dir`` (default ``BUILD_DIR``). nvcc's ptxas report (registers,
    shared memory, spills per kernel) is kept beside the library as
    ``<name>.log``."""
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    so = build_dir / ("libdetex_kernels_%s.so" % _digest())
    key = str(so)
    if key in _LIBS:
        return _LIBS[key]
    if not so.is_file():
        nvcc = find_nvcc()
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = build_dir / ("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *[str(KERNEL_DIR / s) for s in SOURCES]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                               % (proc.returncode, " ".join(cmd),
                                  proc.stderr))
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
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
