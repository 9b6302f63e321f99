"""
Plain PyTorch twins of the CUDA kernels.

Each twin has the signature and outputs of its kernel wrapper in
ops/cuda_kernels.py and is built from ``torch.fft.rfft/irfft``, float64
``cumsum`` and elementwise ops. They are what the port runs when the caller
hands CPU tensors; on a card the main path never calls them, and
``chip_smoke.py`` holds each kernel against its twin on the same inputs.
"""
from __future__ import annotations

import torch

from detex_torch.ops import dft as _dft
from detex_torch.ops.rolling import prefix_sum


def _prep_geometry(n_c, blk):
    pad0 = (-(n_c - 1)) % 128
    D0 = n_c - 1 + pad0
    return pad0, D0, blk - D0


def fwd_prep_fold_ref(xq, nc, n_c, blk, out_len):
    """Twin of cuda_kernels.fwd_prep_fold.

    xq [B, nc, Lp] float32: demuxed standardized chunks with ``pad0``
    leading zeros, zeros past the data, Lp = m*W + D0. Frame f covers
    xq[..., f*W : f*W + blk]. Returns

      Fr, Fi [B*nc, m*Rp]: the real DFT of every frame, bins 0..blk//2 in
        natural order, zeros up to Rp = dft.half_rp(blk);
      a, power [B, m*W]: window mean and n * sample variance of the
        multiplexed window behind output o = f*W + t (samples
        [o + pad0, o + pad0 + n_c) of every channel), a = 0 and power = 1
        for o >= out_len, power 0 -> inf. A window whose samples are all
        equal has power 0 (then inf), by the exact change count of
        rolling.window_stats_rows.
    """
    B, nc_, Lp = xq.shape
    if nc_ != nc:
        raise ValueError("xq has %d channels, expected %d" % (nc_, nc))
    pad0, D0, W = _prep_geometry(n_c, blk)
    if (Lp - D0) % W:
        raise ValueError("Lp = %d is not m*W + D0 (W=%d, D0=%d)"
                         % (Lp, W, D0))
    m = (Lp - D0) // W
    Rp = _dft.half_rp(blk)
    R = blk // 2 + 1
    frames = xq.unfold(2, blk, W)                       # [B, nc, m, blk]
    F = torch.fft.rfft(frames, dim=-1)
    Fr = torch.zeros((B, nc, m, Rp), dtype=torch.float32, device=xq.device)
    Fi = torch.zeros_like(Fr)
    Fr[..., :R] = F.real
    Fi[..., :R] = F.imag
    x64 = xq.to(torch.float64)
    zero = torch.zeros((B, nc, 1), dtype=torch.float64, device=xq.device)
    c1 = torch.cat([zero, torch.cumsum(x64, dim=-1)], dim=-1)
    c2 = torch.cat([zero, torch.cumsum(x64 * x64, dim=-1)], dim=-1)
    o = torch.arange(m * W, device=xq.device)
    s1 = (c1[..., o + pad0 + n_c] - c1[..., o + pad0]).sum(dim=1)
    s2 = (c2[..., o + pad0 + n_c] - c2[..., o + pad0]).sum(dim=1)
    n_win = float(n_c * nc)
    a = s1 / n_win
    var = (s2 - s1 * s1 / n_win) / (n_win - 1.0)
    power = var.clamp(min=0.0) * n_win
    mux = xq.transpose(1, 2).reshape(B, Lp * nc)
    steps = prefix_sum(mux[:, 1:] != mux[:, :-1], torch.int32)
    steps = torch.cat([torch.zeros_like(steps[:, :1]), steps], dim=1)
    j0 = (o + pad0) * nc
    const = steps[:, j0 + n_c * nc - 1] == steps[:, j0]
    power = torch.where((power == 0) | const,
                        torch.full_like(power, float("inf")), power)
    valid = (o < out_len)[None, :]
    a = torch.where(valid, a, torch.zeros_like(a))
    power = torch.where(valid, power, torch.ones_like(power))
    return (Fr.reshape(B * nc, m * Rp), Fi.reshape(B * nc, m * Rp),
            a.to(torch.float32), power.to(torch.float32))


def hist_floor_rule(ds, nbin):
    """Per-row uniform [0, 1] histogram by the floor rule of the fused
    kernels: bin floor(v * nbin) in float32, v == 1.0 in the last bin,
    negative, > 1, -inf and NaN values dropped. ds [R, L] -> int32
    [R, nbin]."""
    R = ds.shape[0]
    idx = torch.floor(ds * float(nbin))
    idx = torch.where(ds == 1.0, torch.full_like(idx, nbin - 1.0), idx)
    keep = (idx >= 0) & (idx < nbin)
    rows = torch.arange(R, device=ds.device)[:, None].expand_as(ds)
    flat = (rows * nbin + idx.clamp(0, nbin - 1).to(torch.int64))[keep]
    return torch.bincount(flat, minlength=R * nbin).reshape(
        R, nbin).to(torch.int32)


def spec_ds_fold_ref(ur, ui, fr, fi, a, power, sum_u, nv, mode, nc, W, head,
                     blk, nbin=0, emit_ds=True):
    """Twin of cuda_kernels.spec_ds_fold.

    ur, ui [D, S, nc, Rp]: template half-spectra with the inverse weights
    c_k/blk folded in (ds.bank_spec_pair); fr, fi [B*nc, m*Rp] block
    spectra; a, power [B, m*W] pre-padded window stats; sum_u [D, S]
    (masked slots 0); nv [B] valid DS lengths. Row r of every output is
    (chunk b, template s) = divmod(r, S) in mode "net" and
    (s, b) = divmod(r, B) in mode "sub". Returns

      ds [BS, m*W] (None unless ``emit_ds``): sum_d (x_d[head:head+W] -
        sum_u[d]*a)^2 / power per block, -inf at positions >= nv;
      pyr [BS, m*(W//128)]: max of every 128-sample block;
      hist [BS, nbin] int32 floor-rule counts (None when nbin == 0).
    """
    D, S = sum_u.shape
    B = nv.shape[0]
    Rp = _dft.half_rp(blk)
    m = fr.shape[1] // Rp
    M = blk // 2
    dev = fr.device
    U = torch.complex(ur, ui).reshape(D, S, nc, Rp)[..., :M + 1]
    F = torch.complex(fr, fi).reshape(B, nc, m, Rp)[..., :M + 1]
    # undo the folded c_k/blk weights: X[k] = Y[k] * blk / c_k
    w = torch.full((M + 1,), blk / 2.0, dtype=torch.float32, device=dev)
    w[0] = w[M] = float(blk)
    acc = torch.zeros((B, S, m * W), dtype=torch.float32, device=dev)
    for d in range(D):
        # the channel sum as a plain multiply-add in channel order, as the
        # kernel sums: every row's value independent of the batch's size
        Y = U[d][None, :, 0, None, :] * F[:, None, 0]
        for c in range(1, nc):
            Y = Y + U[d][None, :, c, None, :] * F[:, None, c]
        Y = Y * w
        x = torch.fft.irfft(Y, n=blk, dim=-1)[..., head:head + W]
        y = x.reshape(B, S, m * W) - sum_u[d][None, :, None] * a[:, None, :]
        acc += y * y
    ds = acc / power[:, None, :]
    pos = torch.arange(m * W, device=dev)
    ds = torch.where(pos[None, None, :] < nv.to(dev)[:, None, None], ds,
                     torch.full_like(ds, float("-inf")))
    if mode == "sub":
        ds = ds.transpose(0, 1)
    elif mode != "net":
        raise ValueError("mode must be 'net' or 'sub', got %r" % (mode,))
    ds = ds.reshape(B * S, m * W)
    pyr = ds.reshape(B * S, (m * W) // 128, 128).amax(dim=-1)
    hist = hist_floor_rule(ds, nbin) if nbin else None
    return (ds if emit_ds else None), pyr, hist


def rfft_ct_fused_ref(x, n):
    """Twin of cuda_kernels.rfft_ct_fused: the real DFT of every row of
    x [N, n] float32, complex64 [N, n//2 + 1]."""
    return torch.fft.rfft(x, n=n, dim=-1)


def irfft_ct_fused_ref(spec, n):
    """Twin of cuda_kernels.irfft_ct_fused: the inverse real DFT of every
    half spectrum spec [N, n//2 + 1] complex64, float32 [N, n] scaled by
    1/n (imaginary parts of bins 0 and n/2 ignored)."""
    return torch.fft.irfft(spec, n=n, dim=-1)


def rfft_ct_half_ref(x, n):
    """Twin of cuda_kernels.rfft_ct_half: the real DFT of every row of
    x [N, n] float32 as a float32 pair (fr, fi) [N, dft.half_rp(n)], bins
    0..n//2 in natural order and zeros past them."""
    f = torch.fft.rfft(x, n=n, dim=-1)
    pad = _dft.half_rp(n) - f.shape[-1]
    return (torch.nn.functional.pad(f.real, (0, pad)),
            torch.nn.functional.pad(f.imag, (0, pad)))


def ds_finalize_os_ref(cb, a, power, sum_u, head, D, W):
    """Twin of cuda_kernels.ds_finalize_os.

    cb [S*D, m, blk] raw overlap-save inverse blocks of one chunk, basis
    row d of DS row r at r*D + d; a, power [m*W] the chunk's window stats
    (a = 0, power = 1 past the valid length); sum_u [S*D] (masked slots
    0). Returns ds [S, m*W] = sum_d (cb[.., head:head+W] - sum_u*a)^2 /
    power (power 0 -> inf), no mask."""
    SD, m, _ = cb.shape
    S = SD // D
    y = (cb[:, :, head:head + W].reshape(S, D, m * W)
         - sum_u.reshape(S, D, 1) * a[None, None, :])
    return (y * y).sum(dim=1) / torch.where(
        power == 0, torch.full_like(power, float("inf")), power)


def ds_finalize_os_scan_ref(cb, a, power, sum_u, nv, head, D, W, nbin=0):
    """Twin of cuda_kernels.ds_finalize_os_scan: ds_finalize_os_ref with
    -inf at positions >= nv (a one-element int32 tensor), the block maxima
    pyr [S, m*W/128] and, for nbin > 0, floor-rule counts hist [S, nbin]
    int32 summed over the chunk's blocks."""
    S = cb.shape[0] // D
    return ds_finalize_os_fold_ref(cb, a[None], power[None], sum_u,
                                   nv.reshape(1), head, D, W, group=S,
                                   nbin=nbin)


def hist_uniform_ref(ds, nbin):
    """Twin of cuda_kernels.hist_uniform: per-row floor-rule counts
    int32 [S, nbin] of ds [S, L] (hist_floor_rule)."""
    return hist_floor_rule(ds, nbin)


def ds_finalize_os_fold_ref(cb, a, power, sum_u, nv, head, D, W, group=1,
                            nbin=0):
    """Twin of cuda_kernels.ds_finalize_os_fold.

    cb [BS*D, m, blk] raw overlap-save inverse blocks, basis row d of DS
    row r at r*D + d; a, power [BS/group, m*W] window stats (padded past
    the valid length), row r reading stats row r // group; sum_u [BS*D]
    (masked slots 0); nv [BS/group] int32 valid DS lengths. Returns

      ds [BS, m*W]: sum_d (cb[.., head:head+W] - sum_u*a)^2 / power
        (power 0 -> inf), -inf at positions >= nv;
      pyr [BS, m*W/128]: max of every 128-sample block;
      hist [BS, nbin] int32 floor-rule counts (None when nbin == 0).
    """
    BSD, m, _ = cb.shape
    BS = BSD // D
    c = torch.arange(BS, device=cb.device) // group
    x = cb[:, :, head:head + W].reshape(BS, D, m * W)
    y = x - sum_u.reshape(BS, D, 1) * a[c][:, None, :]
    p = power[c]
    ds = (y * y).sum(dim=1) / torch.where(
        p == 0, torch.full_like(p, float("inf")), p)
    pos = torch.arange(m * W, device=cb.device)
    ds = torch.where(pos[None, :] < nv.to(torch.int64)[c][:, None], ds,
                     torch.full_like(ds, float("-inf")))
    pyr = ds.reshape(BS, (m * W) // 128, 128).amax(dim=-1)
    return ds, pyr, (hist_floor_rule(ds, nbin) if nbin else None)


def ds_finalize_ref(cc, a, power, sum_u):
    """Twin of cuda_kernels.ds_finalize (detex_tpu's ds_finalize_xla):
    cc [S, D, L], a, power [L] (power already safe: inf where 0), sum_u
    [S, D] -> ds [S, L] = sum_d (cc - sum_u * a)^2 / power."""
    y = cc - sum_u[:, :, None] * a[None, None, :]
    return (y * y).sum(dim=1) / power[None, :]
