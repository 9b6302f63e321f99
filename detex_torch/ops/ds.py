"""
The subspace detection statistic (DS) over overlap-save banks.

Namesake of detex_tpu/ops/ds.py, ported as far as the fused overlap-save
scan and the dense re-verify need it. Reference semantics (Detex _MPXDS
detect.py:559-578): for a multiplexed chunk x and a basis U [D, n],

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

Three ways run a bank over chunks:

  the fused scan     os_prep_batch_fused (kernel fwd_prep_fold) or
                     os_prep_batch_pair (rfft_ct_half) + os_scan_batch_fused
                     (spec_ds_fold): the engine's summary-only scan and the
                     serving scan;
  the unfused batch  os_prep_batch + os_block_scan_batch (rfft_ct_fused,
                     irfft_ct_fused, ds_finalize_os_fold), which writes full
                     DS rows: the scan's "fold" route and the dense
                     re-verify (run_bank_batch, run_bank_rows_batch,
                     run_bank_triggers_batch);
  one chunk at a time  os_prep + _os_block (rfft_ct_fused, irfft_ct_fused,
                     then ds_finalize_os_scan or ds_finalize_os): the scan's
                     "plain" route, run_bank, run_bank_rows and the dense
                     re-verify beyond its caps.

Blocks of 16384 and 32768 samples transform in the kernels, other blocks
with torch.fft (ops/dft.py).
"""
from __future__ import annotations

import numpy as np
import torch

from detex_torch.ops import cuda_kernels as _ck
from detex_torch.ops import dft as _dft
from detex_torch.ops import triggers as _triggers
from detex_torch.ops.rolling import window_stats_rows

# detex_tpu's caps, kept here for every caller: the fused scan's DS array
# (B * S * m * W float32, scan.py:368) and the unfused batch's inverse
# blocks (B * S * Dmax * m * blk float32, scan.py:371, ds.py:970-973).
# Above them the scan and the dense re-verify go one chunk at a time.
FUSED_DS_BYTES = 6 << 30
FOLD_CB_BYTES = 2 << 30

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
    if not _dft.kernel_block(blk_fft):
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
    """The block input of both preps (fused and dense) from a chunk batch
    X [B, Lc] (float32 tensor): per-row standardization (mean and
    population std, sd 0 -> 1), demuxed to [B, nc, L_c] with ``pad0``
    leading zeros and zeros up to Lp = m*W + D0. Returns
    (xq [B, nc, Lp], out_len)."""
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


def os_prep_batch_pair(X, n_c, nc, blk_fft):
    """The fused scan's prep where fwd_prep_fold refuses the geometry
    (n_c > W): X [B, Lc] -> (Fr, Fi [B*nc, m*Rp], a, power [B, out_len]).
    standardize_demux, window stats (rolling.window_stats_rows, not yet
    padded or power-safe), exactly m frames at stride W and their forward
    transform as a (real, imag) pair (dft.rfft_pair: one rfft_ct_half
    launch on the card)."""
    B = X.shape[0]
    L_c = X.shape[1] // nc
    xq, _ = standardize_demux(X, n_c, nc, blk_fft)
    _, pad0, _, W, m = _os_geometry(L_c, n_c, blk_fft)
    a, power = window_stats_rows(xq[:, :, pad0:pad0 + L_c], n_c, n_c * nc)
    Rp = _dft.half_rp(blk_fft)
    fr, fi = _dft.rfft_pair(
        xq.unfold(2, blk_fft, W).reshape(B * nc * m, blk_fft), blk_fft, Rp)
    return fr.reshape(B * nc, m * Rp), fi.reshape(B * nc, m * Rp), a, power


def _pad_stats(a, power, out_len, width):
    """Window stats [..., out_len] padded to ``width`` (a = 0, power = 1
    past out_len) with power made safe (0 -> inf): the finalize's input."""
    pad_w = width - out_len
    pp = torch.where(power == 0, torch.full_like(power, float("inf")), power)
    return (torch.nn.functional.pad(a, (0, pad_w)).contiguous(),
            torch.nn.functional.pad(pp, (0, pad_w), value=1.0).contiguous())


def os_scan_batch_fused(Fr, Fi, a, power, ur, ui, sum_u, d_mask, mode,
                        n_c, nc, blk_fft, L_c, nv, nbin=0, emit_ds=True):
    """One spec_ds_fold launch over the prepped batch: channel FMA, inverse
    transform, DS finalize, pad mask, block maxima and histogram. Returns
    flat row-major (ds [B*S, m*W] or None, pyr [B*S, m*(W//128)],
    hist [B*S, nbin] int32 or None) with rows (chunk, template) in mode
    "net" and (template, chunk) in mode "sub". ``emit_ds=False`` (the
    engine's summary-only scan) never writes the DS array.

    ur, ui: bank_spec_pair output [Dmax, S, nc, Rp]; a / power either
    pre-padded and power-safe from os_prep_batch_fused or [B, out_len]
    from os_prep_batch_pair, padded here (detex_tpu ds.py:695-700)."""
    out_len, _, D0, W, _ = _os_geometry(L_c, n_c, blk_fft)
    Rp = _dft.half_rp(blk_fft)
    width = (Fr.shape[1] // Rp) * W
    if a.shape[1] == out_len:
        a, power = _pad_stats(a, power, out_len, width)
    elif a.shape[1] != width:
        raise ValueError("a / power width %d is neither out_len %d nor "
                         "the padded %d" % (a.shape[1], out_len, width))
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u)).T.contiguous()
    nv = torch.as_tensor(nv, dtype=torch.int32, device=Fr.device)
    return _ck.spec_ds_fold(ur, ui, Fr, Fi, a, power, su, nv, mode, nc, W,
                            D0, blk_fft, nbin=nbin, emit_ds=emit_ds)


def os_prep_batch(X, n_c, nc, blk_fft):
    """Overlap-save prep of the unfused batch: X [B, Lc] float32 ->
    (F [B, nc, m, blk_fft//2 + 1] complex64, a, power [B, out_len]).

    standardize_demux (per-row standardization, demux, padding), window
    stats (rolling.window_stats_rows; power not yet power-safe), exactly m
    overlapping blocks at stride W and their forward transform
    (dft.rfft_ct: one rfft_ct_fused launch on the card)."""
    L_c = X.shape[1] // nc
    xq, _ = standardize_demux(X, n_c, nc, blk_fft)
    _, pad0, _, W, _ = _os_geometry(L_c, n_c, blk_fft)
    a, power = window_stats_rows(xq[:, :, pad0:pad0 + L_c], n_c, n_c * nc)
    F = _dft.rfft_ct(xq.unfold(2, blk_fft, W), blk_fft)
    return F, a, power


def os_block_scan_batch(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft,
                        L_c, nv, nbin=0):
    """DS of every (chunk, template) row from os_prep_batch's output:
    F [B, nc, m, R], a / power [B, out_len], nv [B] valid DS lengths ->
    (ds [B, S, m*W] with -inf past nv, pyr [B, S, m*W/128],
    hist [B, S, nbin] int32 or None).

    The channel cross-spectra are a plain complex multiply-add; the
    inverse blocks [B, S, Dmax, m, blk] come from one irfft_ct_fused
    launch and one ds_finalize_os_fold launch finalizes them, a chunk's S
    rows sharing its stats row."""
    B = F.shape[0]
    S, Dmax = sum_u.shape
    out_len, pad0, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    spec = sum(Ufd2[None, :, :, c, None, :] * F[:, None, None, c]
               for c in range(F.shape[1]))                 # [B, S, D, m, R]
    cb = _dft.irfft_ct(spec, blk_fft)
    del spec
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u))
    ap, pp = _pad_stats(a, power, out_len, m * W)
    dev = F.device
    suf = su[None].expand(B, S, Dmax).reshape(B * S * Dmax).contiguous()
    nv = torch.as_tensor(nv, dtype=torch.int32, device=dev)
    ds, pyr, hist = _ck.ds_finalize_os_fold(
        cb.reshape(B * S * Dmax, m, blk_fft), ap, pp, suf, nv, D0, Dmax, W,
        group=S, nbin=nbin)
    return (ds.reshape(B, S, m * W), pyr.reshape(B, S, -1),
            None if hist is None else hist.reshape(B, S, nbin))


def fold_scan_supported(n_c, blk_fft):
    """True when the unfused batch takes this geometry: a 128-aligned
    advance W >= 128 with W // 128 <= 128, detex_tpu's predicate (ds.py
    718-729) without its Pallas tile budget, which the CUDA kernels do not
    have. Any block length: the transforms run in the kernels at 16384 and
    32768 and with torch.fft otherwise."""
    pad0 = (-(n_c - 1)) % 128
    W = blk_fft - (n_c - 1 + pad0)
    return W >= 128 and W % 128 == 0 and W // 128 <= 128


def os_prep(x, n_c, nc, blk_fft):
    """Prep of one chunk for the per-chunk route: x [Lc] float32 tensor ->
    (F [nc, m, blk_fft//2 + 1] complex64, a, power [out_len]), i.e.
    os_prep_batch of a batch of one (standardization, window stats with
    the exact zero-power rule, exactly m frames at stride W, dft.rfft_ct)."""
    F, a, power = os_prep_batch(x[None], n_c, nc, blk_fft)
    return F[0], a[0], power[0]


def _os_block(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft, L_c,
              nv=None, nbin=0):
    """DS of every template of one chunk from os_prep's output. The channel
    cross-spectra are a plain complex multiply-add, the inverse blocks
    [S, Dmax, m, blk] come from dft.irfft_ct, and the finalize is detex_tpu's
    dispatch (ds.py:392-396): with ``nv`` (the valid length, one int32 on
    the device) and W // 128 <= 128, ds_finalize_os_scan, returning
    (ds [S, m*W] with -inf past nv, pyr [S, m*W/128], hist [S, nbin] int32
    or None); otherwise ds_finalize_os, returning the unmasked ds [S, m*W]
    with ``nv`` and ds[:, :out_len] without."""
    out_len, _, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    S, Dmax = sum_u.shape
    spec = sum(Ufd2[:, :, c, None, :] * F[c][None, None]
               for c in range(F.shape[0]))                 # [S, D, m, R]
    cb = _dft.irfft_ct(spec, blk_fft).reshape(S * Dmax, m, blk_fft)
    del spec
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u)).reshape(-1)
    ap, pp = _pad_stats(a, power, out_len, m * W)
    if nv is not None and W // 128 <= 128:
        return _ck.ds_finalize_os_scan(cb, ap, pp, su, nv, D0, Dmax, W,
                                       nbin=nbin)
    ds = _ck.ds_finalize_os(cb, ap, pp, su, D0, Dmax, W)
    return ds if nv is not None else ds[:, :out_len]


def os_block_scan(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft, L_c,
                  nv, nbin=0):
    """The per-chunk route's DS of one chunk: (ds [S, m*W] with -inf at
    positions >= nv, pyr [S, m*W/128] block maxima, hist [S, nbin] int32
    or None). The histogram comes from ds_finalize_os_scan when ``nbin``
    and W // 128 <= 128; past that width the mask and maxima are plain
    torch (detex_tpu ds.py:421-425) and hist is None."""
    nv = torch.as_tensor(nv, dtype=torch.int32, device=F.device).reshape(1)
    out = _os_block(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft, L_c,
                    nv=nv, nbin=nbin)
    if isinstance(out, tuple):
        return out
    pos = torch.arange(out.shape[1], device=out.device)
    ds = torch.where(pos[None, :] < nv, out,
                     torch.full_like(out, float("-inf")))
    return ds, ds.reshape(ds.shape[0], -1, 128).amax(dim=-1), None


def ds_bank_demux_os(x, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    """Overlap-save DS of one multiplexed chunk x [Lc] (float32 tensor on
    the bank's device): [S, Lc//nc - n_c + 1]."""
    F, a, power = os_prep(x, n_c, nc, blk_fft)
    return _os_block(F, a, power, Ufd2, sum_u, d_mask, n_c, nc, blk_fft,
                     x.shape[0] // nc)


def ds_bank_demux_os_scan(x, nv, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    """os_prep + os_block_scan of one chunk x [Lc] with valid length nv."""
    F, a, power = os_prep(x, n_c, nc, blk_fft)
    return os_block_scan(F, a, power, Ufd2, sum_u, d_mask, n_c, nc,
                         blk_fft, x.shape[0] // nc, nv)


def _run_bank_batch_fold(X, nv, Ufd2, sum_u, d_mask, n_c, nc, blk_fft):
    """DS rows [B, S, m*W] of a chunk batch X [B, Lc] (-inf past nv)."""
    F, a, power = os_prep_batch(X, n_c, nc, blk_fft)
    ds, _, _ = os_block_scan_batch(F, a, power, Ufd2, sum_u, d_mask, n_c, nc,
                                   blk_fft, X.shape[1] // nc, nv)
    return ds


def _require_os(bank):
    if not bank.get("os"):
        raise NotImplementedError(
            "only overlap-save banks are ported: ROADMAP A9")


def _bank_batch_program(Xd, lens, bank, nc):
    """Run the bank over a device-resident chunk batch Xd [B, pad_len]
    with valid lengths ``lens`` (multiplexed samples). Returns (ds on the
    bank's device, lens): [B, S, m*W] with -inf past each valid length from
    the unfused batch, or, beyond fold_scan_supported or the inverse-block
    cap, [B, S, out_len] unmasked from a loop of ds_bank_demux_os over the
    chunks (detex_tpu's _ds_map_demux_os). Callers read each row up to its
    valid length."""
    _require_os(bank)
    n_c, blk = bank["n_c"], bank["blk_fft"]
    pad_len = bank["pad_len"]
    if tuple(Xd.shape) != (len(lens), pad_len):
        raise ValueError("chunk batch %s does not match %d lengths x "
                         "pad_len %d" % (tuple(Xd.shape), len(lens), pad_len))
    Dmax = int(bank["Dmax"])
    S = int(bank["sum_u"].shape[0])
    _, _, _, _, m = _os_geometry(pad_len // int(nc), n_c, blk)
    arrs = (bank["Ufd2"], bank["sum_u"], bank["d_mask"])
    if (fold_scan_supported(n_c, blk)
            and len(lens) * S * Dmax * m * blk * 4 <= FOLD_CB_BYTES):
        nv = [max(_n_valid(L, bank, nc), 0) for L in lens]
        out = _run_bank_batch_fold(Xd, nv, *arrs, n_c, int(nc), blk)
    else:
        out = torch.stack([ds_bank_demux_os(x, *arrs, n_c, int(nc), blk)
                           for x in Xd])
    return out, list(lens)


def _pad_chunk(x_np, bank, nc, pad_len=None):
    """One host chunk cut to ``pad_len`` (default the bank's) and
    zero-padded to it, as a float32 tensor on the bank's device, plus its
    valid length."""
    x_np = np.asarray(x_np)
    Lc = len(x_np)
    if pad_len is None:
        pad_len = bank.get("pad_len", Lc + ((-Lc) % nc))
    Lc = min(Lc, pad_len)
    xp = np.zeros(pad_len, np.float32)
    xp[:Lc] = x_np[:Lc]
    return torch.from_numpy(xp).to(bank["sum_u"].device), Lc


def run_bank(x_np, bank, nc, pad_len=None):
    """Run a bank over one host chunk, zero-padded to ``pad_len`` (default
    the bank's): a numpy [S, n_valid] DS array over the windows fully
    inside the real data (one ds_bank_demux_os, one device-to-host copy)."""
    _require_os(bank)
    xp, Lc = _pad_chunk(x_np, bank, nc, pad_len)
    out = ds_bank_demux_os(xp, bank["Ufd2"], bank["sum_u"], bank["d_mask"],
                           bank["n_c"], int(nc), bank["blk_fft"])
    return out[:, :max(_n_valid(Lc, bank, nc), 0)].cpu().numpy()


def run_bank_rows(x_np, bank, nc, rows):
    """The DS rows ``rows`` of one host chunk from one bank run and one
    device-to-host copy of just those rows: {row_index: numpy float32
    [n_valid]}."""
    rows = [int(si) for si in rows]
    if not rows:
        return {}
    _require_os(bank)
    xp, Lc = _pad_chunk(x_np, bank, nc)
    out = ds_bank_demux_os(xp, bank["Ufd2"], bank["sum_u"], bank["d_mask"],
                           bank["n_c"], int(nc), bank["blk_fft"])
    nv = max(_n_valid(Lc, bank, nc), 0)
    sel = out[torch.as_tensor(rows, device=out.device), :nv].cpu().numpy()
    return dict(zip(rows, sel))


def _bank_batch_out(x_list, bank, nc):
    """Stack host chunks, each cut to the bank's pad_len and zero-padded to
    it, into one float32 batch on the bank's device and run
    _bank_batch_program on it. No power-of-two batch padding: the port has
    no compile classes to share."""
    pad_len = bank["pad_len"]
    X = np.zeros((len(x_list), pad_len), np.float32)
    lens = []
    for i, x in enumerate(x_list):
        L = min(len(x), pad_len)
        X[i, :L] = np.asarray(x[:L], np.float32)
        lens.append(L)
    Xd = torch.from_numpy(X).to(bank["sum_u"].device)
    return _bank_batch_program(Xd, lens, bank, nc)


def _n_valid(L, bank, nc):
    return (int(L) - bank["n"]) // int(nc) + 1


def run_bank_batch(x_list, bank, nc):
    """Run a bank over a list of host chunks in one batch: a list of numpy
    [S, n_valid_i] DS arrays, one per chunk."""
    if not x_list:
        return []
    out, lens = _bank_batch_out(x_list, bank, nc)
    out = out.cpu().numpy()
    return [out[i, :, :max(_n_valid(L, bank, nc), 0)]
            for i, L in enumerate(lens)]


def run_bank_rows_batch(x_list, bank, nc, rows_list):
    """The DS rows ``rows_list[i]`` of every host chunk ``x_list[i]``, from
    one batched bank run and one device-to-host copy of the requested rows:
    a list of {row_index: numpy float32 [n_valid_i]} dicts. A single chunk
    goes to run_bank_rows, as in detex_tpu."""
    if not x_list:
        return []
    if len(x_list) == 1:
        return [run_bank_rows(x_list[0], bank, nc, rows_list[0])]
    out, lens = _bank_batch_out(x_list, bank, nc)
    jobs = [(i, int(si)) for i, rows in enumerate(rows_list) for si in rows]
    got = {}
    if jobs:
        dev = out.device
        sel = out[torch.as_tensor([j[0] for j in jobs], device=dev),
                  torch.as_tensor([j[1] for j in jobs], device=dev)]
        got = dict(zip(jobs, sel.cpu().numpy()))
    res = []
    for i, rows in enumerate(rows_list):
        nv = max(_n_valid(lens[i], bank, nc), 0)
        res.append({int(si): got[(i, int(si))][:nv] for si in rows})
    return res


def run_bank_triggers_batch(x_list, bank, nc, rows_list, thr_list, sr_list,
                            lta_time, sta_time, use_stalta,
                            max_triggers=4096, x_dev=None, lens_dev=None):
    """The engine's dense re-verify of triggered chunks: the bank's DS
    rows, the optional DS STA/LTA and the exact trigger extraction
    (triggers.trigger_rows_device) all run on the bank's device; only the
    per-trigger indices and values come back, in one device-to-host copy
    per group of rows that share (valid length, STA window, LTA window,
    suppression buffer).

    ``rows_list[i]`` are the rows of chunk i to re-verify, ``thr_list[i]``
    their thresholds, ``sr_list[i]`` the chunk's sampling rate (the 20 s
    suppression buffer and the STA/LTA windows are sample counts);
    ``lta_time`` / ``sta_time`` in seconds; ``use_stalta`` computes the
    STA/LTA values. ``x_dev`` / ``lens_dev``: the chunks already on the
    bank's device as a float32 [Nsel, pad_len] tensor plus their valid
    lengths, used instead of uploading ``x_list``.

    Returns one dict per chunk: {row_index: (idx int64 [count],
    ds_at float32 [count], stalta_at float32 [count] | None)}."""
    if not x_list and x_dev is None:
        return []
    if x_dev is not None:
        if x_dev.dtype != torch.float32:
            raise ValueError("x_dev must be float32")
        out, lens = _bank_batch_program(x_dev, list(lens_dev), bank, nc)
        n_chunks = x_dev.shape[0]
    else:
        out, lens = _bank_batch_out(x_list, bank, nc)
        n_chunks = len(x_list)
    res = [dict() for _ in range(n_chunks)]
    groups = {}
    for ci, (rows, thrs, sr) in enumerate(zip(rows_list, thr_list,
                                              sr_list)):
        L = _n_valid(lens[ci], bank, nc)
        if L <= 0:
            z = np.zeros(0, np.float32)
            for si in rows:
                res[ci][int(si)] = (np.zeros(0, np.int64), z,
                                    z if use_stalta else None)
            continue
        buff = int(20 * sr)              # reference buff = 20 s
        # ds_stalta's window clamps
        sta_n = (max(int(sta_time * sr), 0) or 1) if use_stalta else 1
        lta_n = max(int(lta_time * sr), 1) if use_stalta else 1
        for si, thr in zip(rows, thrs):
            groups.setdefault((L, sta_n, lta_n, buff), []).append(
                (ci, int(si), float(thr)))
    dev = out.device
    for (L, sta_n, lta_n, buff), jobs in groups.items():
        cis = torch.as_tensor([j[0] for j in jobs], device=dev)
        sis = torch.as_tensor([j[1] for j in jobs], device=dev)
        thr = torch.as_tensor([j[2] for j in jobs], dtype=torch.float32,
                              device=dev)
        idx, cnt, dsv, slv = _triggers.trigger_rows_device(
            out[cis, sis], thr, L, sta_n, lta_n, buff, max_triggers,
            use_stalta)
        # one copy: counts, indices and values side by side in float64
        # (indices < 2^53 and float32 values round-trip exactly)
        parts = [cnt[:, None], idx, dsv] + ([slv] if use_stalta else [])
        packed = torch.cat([p.to(torch.float64) for p in parts],
                           dim=1).cpu().numpy()
        k = idx.shape[1]
        for row, (ci, si, _) in zip(packed, jobs):
            nf = int(row[0])
            res[ci][si] = (row[1:1 + nf].astype(np.int64),
                           row[1 + k:1 + k + nf].astype(np.float32),
                           row[1 + 2 * k:1 + 2 * k + nf].astype(np.float32)
                           if use_stalta else None)
    return res


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
