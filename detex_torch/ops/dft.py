"""
Block-transform geometry and twiddle tables for the CUDA kernels.

Namesake of detex_tpu/ops/dft.py. The TPU package splits each 16384-point
transform into two 128 x 128 matrix stages (``_split``, ``_ct_mats_half``)
because its matrix unit is the fast path there. The CUDA kernels instead run
an FFT of the real signal packed as n/2 complex points, 32 points a thread
in registers over three Stockham passes (radix 16, 16, 32 at n = 16384; 16,
32, 32 at 32768) with two exchanges through shared memory
(kernels/fft_regs.cuh): the forward block transforms (rfft_ct_fused,
rfft_ct_half, and the frames of fwd_prep_fold) with two rows resident per
SM at 16384, reading overlapping frames in place; its inverse (the pack
pre-pass in registers, the conjugate roots, samples handed over from
registers) in irfft_ct_fused, two rows per SM at 16384, and inside
spec_ds_fold. What they need from this module is the split (still the
legality rule of the block kernels, n1 == 128), the padded spectrum width
``half_rp`` and the tables of roots of unity, built in float64 on the host
and cast to float32 (``twiddles`` for every kernel, ``stage_twiddles`` laid
out per pass and lane for the register-resident core; the inverse
conjugates them). ``rfft_ct`` /
``rfft_frames`` / ``irfft_ct`` are the block transforms of the dense
re-verify and the per-chunk route (ops/ds.py os_prep_batch,
os_block_scan_batch, _os_block), ``rfft_pair`` / ``rfft_pair_frames`` the
forward transform of the fused scan's unfused prep (ds.os_prep_batch_pair).
Blocks of 16384 and 32768 samples go to the kernels; any other block length
to ``torch.fft`` (where detex_tpu runs its XLA matrix DFT, not a Pallas
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


_STAGE_TWIDDLES = {}


def stage_twiddles(n, device):
    """Roots of unity of the second and third pass of the register-resident
    FFT core (kernels/fft_regs.cuh; forward as stored, inverse by
    conjugation in the kernel), float32 [16*R2 + n//2, 2] as (re, im) pairs
    with M = n//2 points, T = M//32 threads and R2 = 16 (n = 16384) or 32
    (n = 32768): first exp(-2*pi*i*r*j/(16*R2)) at [r*16 + j], r < R2,
    j < 16, then exp(-2*pi*i*r*t/M) at [16*R2 + r*T + t], r < 32, t < T,
    so that the lanes of a warp load neighbouring entries. Built in float64
    on the host, cast once and cached per (n, device)."""
    if not kernel_block(n):
        raise ValueError("no block transform kernel for n = %d" % n)
    device = torch.device(device)
    key = (int(n), str(device))
    if key not in _STAGE_TWIDDLES:
        M = n // 2
        T = M // 32
        R2 = M // (16 * 32)
        e2 = np.outer(np.arange(R2), np.arange(16)) % (16 * R2)
        e3 = np.outer(np.arange(32), np.arange(T)) % M
        ang = -2.0 * np.pi * np.concatenate(
            [e2.ravel() / (16.0 * R2), e3.ravel() / float(M)])
        tab = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
        _STAGE_TWIDDLES[key] = torch.from_numpy(tab).to(device)
    return _STAGE_TWIDDLES[key]


def _frames(xq, n, W, m):
    """The m frames of n samples at stride W of every row of xq [..., Lp]
    as a view [..., m, n]."""
    if (m - 1) * W + n > xq.shape[-1]:
        raise ValueError("%d frames of %d at stride %d do not fit rows of %d"
                         % (m, n, W, xq.shape[-1]))
    return xq.unfold(-1, n, W)[..., :m, :]


def rfft_frames(xq, n, W, m):
    """== rfft_ct(xq.unfold(-1, n, W)[..., :m, :], n): the forward transform
    of m frames of n samples at stride W of every row of xq [..., Lp]
    float32 -> complex64 [..., m, n//2 + 1]. When kernel_block(n), one
    rfft_ct_fused launch that reads the overlapping frames in place (on the
    card no copy of them is made); else torch.fft.rfft of the view."""
    from detex_torch.ops import cuda_kernels as _ck
    if not kernel_block(n):
        return torch.fft.rfft(_frames(xq, n, W, m), n=n, dim=-1)
    lead = xq.shape[:-1]
    out = _ck.rfft_ct_fused(xq.reshape(-1, xq.shape[-1]), n, stride=W,
                            frames=m)
    return out.reshape(lead + (m, n // 2 + 1))


def rfft_pair_frames(xq, n, W, m, rp):
    """== rfft_pair of the m frames of n samples at stride W of every row
    of xq [..., Lp] float32: the (real, imag) pair [rows * m, rp], frame f
    of row r at r*m + f. When kernel_block(n) and rp == half_rp(n), one
    rfft_ct_half launch that reads the frames in place."""
    from detex_torch.ops import cuda_kernels as _ck
    if kernel_block(n) and rp == half_rp(n):
        return _ck.rfft_ct_half(xq.reshape(-1, xq.shape[-1]), n, stride=W,
                                frames=m)
    return rfft_pair(_frames(xq, n, W, m).reshape(-1, n), n, rp)


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
