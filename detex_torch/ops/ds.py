"""
The subspace detection statistic (DS) over overlap-save banks.

Namesake of detex_tpu/ops/ds.py, ported as far as the fused overlap-save
scan needs it. Reference semantics (Detex _MPXDS detect.py:559-578): for a
multiplexed chunk x and a basis U [D, n],

    a     = rolling_mean(x, n)
    power = n * rolling_sample_var(x, n)
    y_d   = correlate(x, U_d) - sum(U_d) * a
    DS    = sum_d y_d^2 / power, taken at every nc-th window start

evaluated per channel on the demultiplexed chunk (polyphase form) and by
overlap-save: the chunk's channels are cut into blocks of ``blk_fft``
samples at stride W, transformed once, multiplied by the template spectra
and inverted, dropping each block's circularly contaminated head D0.

A bank is a dict of tensors with detex_tpu's keys (Ufd2, sum_u, d_mask and
the int statics n, n_c, Dmax, nc, blk_fft, pad_len). Only the overlap-save
form is ported; the full-length and multiplexed forms raise
NotImplementedError (ROADMAP A9).
"""
from __future__ import annotations

import numpy as np
import torch

from detex_torch.ops import cuda_kernels as _ck
from detex_torch.ops import dft as _dft

# The fused kernels need a block with the 128-row split (n1 == 128); 16384
# is the smallest. A shorter natural block always snaps up to it when the
# chunk is long enough (detex_tpu snaps only when its Pallas and matmul-DFT
# switches are on, ds.py:817-827; here it is the rule).
FUSED_BLOCK = 16384

# Row-order rule of the fused scan: mode "net" (rows (chunk, template)) when
# the template count is a multiple of this, else "sub". It is detex_tpu's
# kernel tile (SPEC_DS_ST); the CUDA kernel needs no tile, so "sub" takes
# any chunk count.
ROW_TILE = 8

def os_min_block(n_c):
    """Smallest legal overlap-save block for per-channel template length
    n_c: the 128-aligned discard head plus one 128-sample output stride."""
    pad0 = (-(n_c - 1)) % 128
    return n_c - 1 + pad0 + 128


def _os_geometry(L_c, n_c, blk_fft):
    """(out_len, pad0, D0, W, m) of the 128-aligned overlap-save
    decomposition: pad0 leading zeros make the discard head D0 >= n_c - 1 a
    multiple of 128, W = blk - D0 is the block advance and m the block
    count covering out_len = L_c - n_c + 1 outputs."""
    out_len = L_c - n_c + 1
    pad0 = (-(n_c - 1)) % 128
    D0 = n_c - 1 + pad0
    W = blk_fft - D0
    if W < 128:
        raise ValueError("block FFT %d too small for template length %d"
                         % (blk_fft, n_c))
    m = -(-out_len // W)
    return out_len, pad0, D0, W, m


def pad_rows(S):
    """Detector-row count ladder of shape-canonical banks: the smallest
    S' >= S that is a multiple of max(8, 2^(bit_length(S-1)-3))."""
    S = int(S)
    if S <= 8:
        return 8
    q = max(8, 1 << (int(S - 1).bit_length() - 3))
    return -(-S // q) * q


def pad_dims(D):
    """Basis-dimension ladder: the next power of two."""
    return 1 << max(int(D - 1).bit_length(), 0)


def make_bank_demux_os(U_list, nc, blk_fft, device):
    """Pack [D_i, n] multiplexed bases into an overlap-save demuxed bank on
    ``device``: Ufd2 [S, Dmax, nc, blk_fft//2+1] complex64 (rfft of the
    reversed per-channel templates, computed in float64 on the host),
    sum_u [S, Dmax] float32, d_mask [S, Dmax] bool."""
    n = U_list[0].shape[1]
    if n % nc:
        raise ValueError("template length %d is not a multiple of nc=%d"
                         % (n, nc))
    n_c = n // nc
    if blk_fft < os_min_block(n_c):
        raise ValueError("block FFT too small: need >= aligned head + 128 "
                         "(os_min_block(n_c) = %d)" % os_min_block(n_c))
    S = len(U_list)
    Dmax = max(u.shape[0] for u in U_list)
    Ud = np.zeros((S, Dmax, nc, n_c), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    sum_u = np.zeros((S, Dmax), dtype=np.float64)
    for i, u in enumerate(U_list):
        u = np.asarray(u, np.float64)
        for d in range(u.shape[0]):
            Ud[i, d] = u[d].reshape(n_c, nc).T
        mask[i, :u.shape[0]] = True
        sum_u[i, :u.shape[0]] = u.sum(axis=-1)
    Ufd2 = np.fft.rfft(Ud[..., ::-1], int(blk_fft), axis=-1)
    return dict(
        Ufd2=torch.as_tensor(Ufd2.astype(np.complex64), device=device),
        sum_u=torch.as_tensor(sum_u.astype(np.float32), device=device),
        d_mask=torch.as_tensor(mask, device=device),
        n=int(n), n_c=int(n_c), Dmax=int(Dmax), nc=int(nc),
        blk_fft=int(blk_fft), demux=True, os=True)


def build_bank(U_list, nc, data_len_samps, device, block_fft=None):
    """Pack basis arrays into an overlap-save bank for chunks of
    ``data_len_samps`` multiplexed samples (detex_tpu ds.build_bank with
    prefer_os=True). Records ``pad_len``, the fixed chunk length.

    The block is ``block_fft`` when given, else 2^bit_length(4*n_c) raised
    to os_min_block and snapped up to FUSED_BLOCK (when the chunk's
    full-length FFT is at least that long). What detex_tpu serves with a
    full-length or multiplexed bank (``block_fft=0``, template length not a
    multiple of nc, chunks shorter than one block) raises
    NotImplementedError (ROADMAP A9)."""
    n = U_list[0].shape[1]
    pad_len = int(data_len_samps)
    pad_len += (-pad_len) % nc
    if n % nc:
        raise NotImplementedError(
            "multiplexed bank (template length %d not a multiple of nc=%d) "
            "is not ported yet: ROADMAP A9" % (n, nc))
    if block_fft == 0:
        raise NotImplementedError(
            "full-length demuxed bank is not ported yet: ROADMAP A9")
    n_c = n // nc
    L_c = pad_len // nc
    nfft2 = 2 ** int(L_c + n_c).bit_length()
    blk = int(block_fft) if block_fft else 2 ** int(4 * n_c).bit_length()
    while blk < os_min_block(n_c):
        blk *= 2
    if not block_fft and blk < FUSED_BLOCK and nfft2 >= FUSED_BLOCK:
        blk = FUSED_BLOCK
    blk = min(blk, nfft2)
    if blk < os_min_block(n_c):
        raise NotImplementedError(
            "chunk too short for overlap-save blocks; the full-length bank "
            "is not ported yet: ROADMAP A9")
    bank = make_bank_demux_os(U_list, nc, blk, device)
    bank["pad_len"] = pad_len
    return bank


def bank_from_numpy(d, device):
    """The port's bank from a detex_tpu overlap-save bank's arrays given as
    numpy (Ufd2, sum_u, d_mask) plus its int statics, so both packages
    compute with identical template spectra."""
    if not d.get("os"):
        raise NotImplementedError(
            "only overlap-save banks are ported: ROADMAP A9")
    out = dict(
        Ufd2=torch.tensor(np.asarray(d["Ufd2"]).astype(np.complex64),
                          device=device),
        sum_u=torch.tensor(np.asarray(d["sum_u"], np.float32), device=device),
        d_mask=torch.tensor(np.asarray(d["d_mask"], bool), device=device),
        demux=True, os=True)
    for k in ("n", "n_c", "Dmax", "nc", "blk_fft", "pad_len"):
        if k in d:
            out[k] = int(d[k])
    return out


def bank_spec_pair(bank):
    """Template spectra for the fused scan kernel as a float32 (real, imag)
    pair [Dmax, S, nc, Rp] (basis-dim-major, zeros past blk//2), cached on
    the bank. The inverse weights c_k/blk (c_0 = c_{blk/2} = 1, else 2) are
    folded in, so the kernel's channel FMA yields the weighted half
    spectrum directly. Masked basis slots are identically zero."""
    if "_spec_pair" not in bank:
        Ufd2 = bank["Ufd2"]
        blk = bank["blk_fft"]
        R = Ufd2.shape[-1]
        Rp = _dft.half_rp(blk)
        k = np.arange(Rp)
        wk = np.where((k == 0) | (k >= blk // 2), 1.0, 2.0) / blk
        wk = torch.as_tensor(wk.astype(np.float32), device=Ufd2.device)

        def part(v):
            out = torch.zeros(Ufd2.shape[:-1] + (Rp,), dtype=torch.float32,
                              device=Ufd2.device)
            out[..., :R] = v
            return (out * wk).permute(1, 0, 2, 3).contiguous()

        bank["_spec_pair"] = (part(Ufd2.real), part(Ufd2.imag))
    return bank["_spec_pair"]


def _fused_geometry_ok(n_c, blk_fft):
    """Geometric legality shared by both fused kernels: power-of-two blk
    with the 128-row split and a 128-aligned advance W."""
    b = int(blk_fft).bit_length() - 1
    if (1 << b) != blk_fft or (1 << (b // 2)) != 128:
        return False
    pad0 = (-(n_c - 1)) % 128
    W = blk_fft - (n_c - 1 + pad0)
    return W >= 128 and W % 128 == 0


def fwd_prep_ok(n_c, nc, blk_fft):
    """True when the fused forward-prep kernel serves this geometry (the
    stats window must fit inside one frame advance: n_c <= W)."""
    if not _fused_geometry_ok(n_c, blk_fft):
        return False
    pad0 = (-(n_c - 1)) % 128
    return n_c <= blk_fft - (n_c - 1 + pad0)


def spec_ds_mode(B, S, Dmax, n_c, nc, blk_fft):
    """Row-ordering mode of the fused spec -> DS kernel ("net" when
    S % ROW_TILE == 0, else "sub"), or None when the geometry is not
    legal for it (W // 128 must fit one 128-wide block-maxima row)."""
    if not _fused_geometry_ok(n_c, blk_fft):
        return None
    pad0 = (-(n_c - 1)) % 128
    if (blk_fft - (n_c - 1 + pad0)) // 128 > 128:
        return None
    return "net" if S % ROW_TILE == 0 else "sub"


def standardize_demux(X, n_c, nc, blk_fft):
    """The fused prep's input from a chunk batch X [B, Lc] (float32
    tensor): per-row standardization (mean and population std, sd 0 -> 1),
    demuxed to [B, nc, L_c] with ``pad0`` leading zeros and zeros up to
    Lp = m*W + D0. Returns (xq [B, nc, Lp], out_len)."""
    B, Lc = X.shape
    L_c = Lc // nc
    out_len, pad0, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    sd, mu = torch.std_mean(X, dim=1, correction=0, keepdim=True)
    inv = 1.0 / torch.where(sd == 0, torch.ones_like(sd), sd)
    xq = torch.empty((B, nc, m * W + D0), dtype=torch.float32,
                     device=X.device)
    xq[:, :, :pad0] = 0.0
    xq[:, :, pad0 + L_c:] = 0.0
    # one pass: (x - mu) / sd as x * inv - mu * inv, demuxed into place
    torch.addcmul((-mu * inv)[:, :, None],
                  X[:, :L_c * nc].reshape(B, L_c, nc).transpose(1, 2),
                  inv[:, :, None], out=xq[:, :, pad0:pad0 + L_c])
    return xq, out_len


def os_prep_batch_fused(X, n_c, nc, blk_fft):
    """Overlap-save prep of a chunk batch X [B, Lc]: standardize_demux,
    then ONE fwd_prep_fold launch. Returns (Fr, Fi [B*nc, m*Rp],
    a, power [B, m*W]); a / power come pre-padded (a = 0, power = 1 past
    out_len) and power-safe (0 -> inf)."""
    xq, out_len = standardize_demux(X, n_c, nc, blk_fft)
    return _ck.fwd_prep_fold(xq, nc, n_c, blk_fft, out_len)


def os_scan_batch_fused(Fr, Fi, a, power, ur, ui, sum_u, d_mask, mode,
                        n_c, nc, blk_fft, L_c, nv, nbin=0, emit_ds=True):
    """One spec_ds_fold launch over the prepped batch: channel FMA, inverse
    transform, DS finalize, pad mask, block maxima and histogram. Returns
    flat row-major (ds [B*S, m*W] or None, pyr [B*S, m*(W//128)],
    hist [B*S, nbin] int32 or None) with rows (chunk, template) in mode
    "net" and (template, chunk) in mode "sub". ``emit_ds=False`` (the
    engine's summary-only scan) never writes the DS array.

    ur, ui: bank_spec_pair output [Dmax, S, nc, Rp]; a / power from
    os_prep_batch_fused (pre-padded)."""
    _, _, D0, W, _ = _os_geometry(L_c, n_c, blk_fft)
    Rp = _dft.half_rp(blk_fft)
    if a.shape[1] != (Fr.shape[1] // Rp) * W:
        raise ValueError("a / power must come pre-padded from "
                         "os_prep_batch_fused: width %d, expected %d"
                         % (a.shape[1], (Fr.shape[1] // Rp) * W))
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u)).T.contiguous()
    nv = torch.as_tensor(nv, dtype=torch.int32, device=Fr.device)
    return _ck.spec_ds_fold(ur, ui, Fr, Fi, a, power, su, nv, mode, nc, W,
                            D0, blk_fft, nbin=nbin, emit_ds=emit_ds)


def ds_numpy(x, U, nc):
    """float64 numpy oracle of the DS statistic (detex_tpu ds.ds_numpy)."""
    x = np.asarray(x, np.float64)
    U = np.asarray(U, np.float64)
    D, n = U.shape
    Lc = len(x)
    # nfft >= Lc keeps the sliced region [n-1:Lc] free of circular wrap
    nfft = 2 ** int(Lc).bit_length()
    c = np.cumsum(np.insert(x, 0, 0.0))
    c2 = np.cumsum(np.insert(x * x, 0, 0.0))
    rsum = c[n:] - c[:-n]
    rsum2 = c2[n:] - c2[:-n]
    a = rsum / n
    var_samp = (rsum2 - rsum * rsum / n) / (n - 1)
    power = var_samp * n
    xfd = np.fft.rfft(x, nfft)
    Ufd = np.fft.rfft(U[:, ::-1], nfft, axis=-1)
    cc = np.fft.irfft(Ufd * xfd[None, :], nfft, axis=-1)[:, n - 1:Lc]
    y = cc - U.sum(axis=1)[:, None] * a[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        ds = (y ** 2).sum(axis=0) / power
    return ds[::nc]
