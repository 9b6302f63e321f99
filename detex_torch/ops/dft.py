"""
Block-transform geometry and twiddle tables for the CUDA kernels.

Namesake of detex_tpu/ops/dft.py. The TPU package splits each 16384-point
transform into two 128 x 128 matrix stages (``_split``, ``_ct_mats_half``)
because its matrix unit is the fast path there. The CUDA kernels instead run
a shared-memory Stockham FFT (four radix-8 passes, then one radix-2 or
radix-4 pass) of the real signal packed as n/2 complex points
(kernels/fft.cuh), so what they need from this module is the split (still
the legality rule of the block kernels, n1 == 128), the padded spectrum
width ``half_rp`` and one table of roots of unity, built in float64 on the
host and cast to float32. ``rfft_ct`` / ``irfft_ct`` are the block
transforms of the dense re-verify and the per-chunk route (ops/ds.py
os_prep_batch, os_block_scan_batch, _os_block), ``rfft_pair`` the forward
transform of the fused scan's unfused prep (ds.os_prep_batch_pair). Blocks
of 16384 and 32768 samples go to the kernels; any other block length to
``torch.fft`` (where detex_tpu runs its XLA matrix DFT, not a Pallas
kernel). ``irfft_full`` is the inverse of the full-length banks and of the
device prep (ops/ds.py, ops/prep.py), always ``torch.fft``, as detex_tpu
uses ``jnp.fft`` there.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _split(n):
    """n = n1 * n2 with both powers of two, n1 <= n2."""
    b = int(n).bit_length() - 1
    if (1 << b) != n:
        raise ValueError("block transform needs a power-of-two length, "
                         "got %d" % n)
    n1 = 1 << (b // 2)
    return n1, n // n1


def half_rp(n):
    """Padded spectrum width of one block: (n1//2 + 1) * n2 = n//2 + n2.
    Bins 0..n//2 hold the real DFT in natural order; the port writes zeros
    past n//2 (detex_tpu leaves mirror-frequency values there; both are
    inert, the inverse only reads bins 0..n//2)."""
    n1, n2 = _split(n)
    return (n1 // 2 + 1) * n2


def kernel_block(n):
    """True for the block lengths the transform kernels take: a power of
    two with the 128-row split (n1 == 128), i.e. 16384 or 32768."""
    b = int(n).bit_length() - 1
    return (1 << b) == n and (1 << (b // 2)) == 128


_TWIDDLES = {}


def twiddles(n, device):
    """[n//2, 2] float32 table of exp(-2*pi*i*k/n), k < n//2, as (re, im)
    pairs: built in float64 on the host, cast once and cached per
    (n, device). The kernels read every root of unity from it (no
    __sinf/__cosf)."""
    device = torch.device(device)
    key = (int(n), str(device))
    if key not in _TWIDDLES:
        k = np.arange(n // 2, dtype=np.float64)
        ang = -2.0 * np.pi * k / n
        tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
        _TWIDDLES[key] = torch.from_numpy(tab).to(device)
    return _TWIDDLES[key]


def rfft_ct(x, n):
    """== torch.fft.rfft(x, n, dim=-1): x [..., L] float32, zero-padded or
    truncated to n, -> complex64 [..., n//2 + 1]. One rfft_ct_fused launch
    over all rows when kernel_block(n), else torch.fft.rfft."""
    from detex_torch.ops import cuda_kernels as _ck
    if not kernel_block(n):
        return torch.fft.rfft(x, n=n, dim=-1)
    L = x.shape[-1]
    if L < n:
        x = F.pad(x, (0, n - L))
    elif L > n:
        x = x[..., :n]
    lead = x.shape[:-1]
    out = _ck.rfft_ct_fused(x.reshape(-1, n).contiguous(), n)
    return out.reshape(lead + (n // 2 + 1,))


def irfft_ct(spec, n):
    """== torch.fft.irfft(spec, n, dim=-1) for a half spectrum
    spec [..., n//2 + 1] complex64 -> float32 [..., n]. One irfft_ct_fused
    launch over all rows when kernel_block(n), else torch.fft.irfft.
    Unlike detex_tpu's namesake it never builds the hermitian extension:
    the kernel packs the half spectrum itself."""
    from detex_torch.ops import cuda_kernels as _ck
    if spec.shape[-1] != n // 2 + 1:
        raise ValueError("spec has %d bins, expected n//2 + 1 = %d"
                         % (spec.shape[-1], n // 2 + 1))
    if not kernel_block(n):
        return torch.fft.irfft(spec, n=n, dim=-1)
    lead = spec.shape[:-1]
    out = _ck.irfft_ct_fused(spec.reshape(-1, n // 2 + 1).contiguous(), n)
    return out.reshape(lead + (n,))


def rfft_pair(x, n, rp):
    """Forward transform of real x [N, n] float32 as a (real, imag) pair
    [N, rp], bins 0..n//2 in natural order and zeros past them (detex_tpu
    leaves mirror values there; both are inert, the fused scan reads bins
    0..n//2 only). One rfft_ct_half launch when kernel_block(n) and
    rp == half_rp(n), else torch.fft.rfft."""
    from detex_torch.ops import cuda_kernels as _ck
    if not n // 2 + 1 <= rp <= n:
        raise ValueError("rp = %d outside [n//2 + 1, n] for n = %d"
                         % (rp, n))
    if kernel_block(n) and rp == half_rp(n):
        return _ck.rfft_ct_half(x.contiguous(), n)
    f = torch.fft.rfft(x, n=n, dim=-1)
    pad = rp - f.shape[-1]
    return F.pad(f.real, (0, pad)), F.pad(f.imag, (0, pad))


def irfft_full(spec, n):
    """torch.fft.irfft(spec, n, dim=-1) with the imaginary parts of bin 0
    and, when spec has n//2 + 1 bins, bin n/2 taken as 0, as numpy's and
    XLA's irfft take them. A truncated or filtered spectrum has them (the
    last bin kept after spectral decimation is not the Nyquist bin of the
    transform it came from); cuFFT's C2R does not promise to ignore them, so
    they are zeroed here on every device. Zeroes them in place: ``spec``
    must be a temporary the caller owns."""
    v = torch.view_as_real(spec)
    v[..., 0, 1] = 0.0
    if n % 2 == 0 and spec.shape[-1] == n // 2 + 1:
        v[..., n // 2, 1] = 0.0
    return torch.fft.irfft(spec, n=n, dim=-1)
