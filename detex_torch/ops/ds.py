"""
The subspace detection statistic (DS) over every bank form.

Namesake of detex_tpu/ops/ds.py. Reference semantics (Detex _MPXDS
detect.py:559-578): for a multiplexed chunk x and a basis U [D, n],

    a     = rolling_mean(x, n)
    power = n * rolling_sample_var(x, n)
    y_d   = correlate(x, U_d) - sum(U_d) * a
    DS    = sum_d y_d^2 / power, taken at every nc-th window start

A bank is a dict of tensors with detex_tpu's keys (sum_u, d_mask and the
int statics n, Dmax, nc, pad_len) in one of three forms (bank_kind):

  "os"     overlap-save demuxed (Ufd2 at blk_fft, n_c, os=True): the
           chunk's channels are cut into blocks of blk_fft samples at
           stride W, transformed once, multiplied by the template spectra
           and inverted, dropping each block's circularly contaminated head
           D0;
  "demux"  full-length demuxed (Ufd2 at the chunk's FFT length nfft2,
           n_c): one rfft per channel, the channel-summed cross-spectra,
           one irfft per (template, basis row) and the ds_finalize kernel
           (ds_bank_demux);
  "mux"    multiplexed (Ufd at nfft), for a template length that is not a
           multiple of nc: the statistic over the interleaved stream in
           torch, no kernel (ds_bank).

build_bank picks the form by detex_tpu's rule. Three ways run an
overlap-save bank over chunks:

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

Full-length and multiplexed banks always go one chunk at a time, on every
entry point. Blocks of 16384 and 32768 samples transform in the kernels,
other blocks and every full-length transform with torch.fft (ops/dft.py).
"""
from __future__ import annotations

import numpy as np
import torch

from detex_torch import trace as _trace
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

# full-length spectra above this many complex elements (S * Dmax * nc *
# (nfft2//2 + 1)) switch a bank to the overlap-save form (detex_tpu's
# OS_SPECTRA_BUDGET)
OS_SPECTRA_BUDGET = 1 << 26

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


def required_fft_len(data_len_samps, n):
    """The reference's FFT length 2^bit_length(data_len + n) (detect.py
    368-371, fas.py:147-148)."""
    return 2 ** int(int(data_len_samps) + int(n)).bit_length()


def prep_basis_fd(U, nfft):
    """rfft of the reversed basis vectors U [..., n] at length nfft, in
    float64 on the host (reference _loadMPSubSpace detect.py:371): numpy
    complex128 [..., nfft//2 + 1]."""
    U = np.asarray(U, np.float64)
    return np.fft.rfft(U[..., ::-1], int(nfft), axis=-1)


def _bank_tensors(spec, sum_u, mask, device):
    return (torch.as_tensor(spec.astype(np.complex64), device=device),
            torch.as_tensor(sum_u.astype(np.float32), device=device),
            torch.as_tensor(mask, device=device))


def make_bank(U_list, nfft, device="cuda", min_dmax=0):
    """Pack [D_i, n] multiplexed bases (equal n) into a multiplexed bank on
    ``device``: Ufd [S, Dmax, nfft//2+1] complex64, sum_u [S, Dmax] float32,
    d_mask [S, Dmax] bool, n, Dmax. ``min_dmax`` pads the basis slots with
    masked zero slots."""
    n = U_list[0].shape[1]
    if any(u.shape[1] != n for u in U_list):
        raise ValueError("bank templates differ in length")
    S = len(U_list)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    U = np.zeros((S, Dmax, n), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    for i, u in enumerate(U_list):
        U[i, :u.shape[0]] = u
        mask[i, :u.shape[0]] = True
    Ufd, sum_u, d_mask = _bank_tensors(prep_basis_fd(U, nfft), U.sum(axis=-1),
                                       mask, device)
    return dict(Ufd=Ufd, sum_u=sum_u, d_mask=d_mask, n=int(n), Dmax=int(Dmax))


def _demux_basis(U_list, nc, min_dmax):
    """The demultiplexed templates Ud [S, Dmax, nc, n_c] (float64), the
    mask and the basis sums of [D_i, n] multiplexed bases."""
    n = U_list[0].shape[1]
    if n % nc:
        raise ValueError("template length %d is not a multiple of nc=%d"
                         % (n, nc))
    n_c = n // nc
    S = len(U_list)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    Ud = np.zeros((S, Dmax, nc, n_c), dtype=np.float64)
    mask = np.zeros((S, Dmax), dtype=bool)
    sum_u = np.zeros((S, Dmax), dtype=np.float64)
    for i, u in enumerate(U_list):
        u = np.asarray(u, np.float64)
        for d in range(u.shape[0]):
            Ud[i, d] = u[d].reshape(n_c, nc).T
        mask[i, :u.shape[0]] = True
        sum_u[i, :u.shape[0]] = u.sum(axis=-1)
    return Ud, mask, sum_u, dict(n=int(n), n_c=int(n_c), Dmax=int(Dmax),
                                 nc=int(nc))


def make_bank_demux(U_list, nc, nfft2, device="cuda", min_dmax=0):
    """Pack [D_i, n] multiplexed bases into a full-length demuxed bank on
    ``device``: Ufd2 [S, Dmax, nc, nfft2//2+1] complex64 (rfft of the
    reversed per-channel templates at the chunk's full FFT length, computed
    in float64 on the host), sum_u [S, Dmax] float32, d_mask [S, Dmax]
    bool."""
    Ud, mask, sum_u, st = _demux_basis(U_list, nc, min_dmax)
    Ufd2, su, dm = _bank_tensors(prep_basis_fd(Ud, nfft2), sum_u, mask,
                                 device)
    return dict(Ufd2=Ufd2, sum_u=su, d_mask=dm, **st, nfft2=int(nfft2),
                demux=True)


def make_bank_demux_os(U_list, nc, blk_fft, device="cuda", min_dmax=0):
    """Pack [D_i, n] multiplexed bases into an overlap-save demuxed bank on
    ``device``: Ufd2 [S, Dmax, nc, blk_fft//2+1] complex64 (rfft of the
    reversed per-channel templates, computed in float64 on the host),
    sum_u [S, Dmax] float32, d_mask [S, Dmax] bool."""
    Ud, mask, sum_u, st = _demux_basis(U_list, nc, min_dmax)
    if blk_fft < os_min_block(st["n_c"]):
        raise ValueError("block FFT too small: need >= aligned head + 128 "
                         "(os_min_block(n_c) = %d)" % os_min_block(st["n_c"]))
    Ufd2, su, dm = _bank_tensors(prep_basis_fd(Ud, blk_fft), sum_u, mask,
                                 device)
    return dict(Ufd2=Ufd2, sum_u=su, d_mask=dm, **st, blk_fft=int(blk_fft),
                demux=True, os=True)


def build_bank(U_list, nc, data_len_samps, device="cuda", block_fft=None,
               prefer_os=True, pad_S=None, min_dmax=0):
    """Pack basis arrays into a bank on ``device`` for chunks of
    ``data_len_samps`` multiplexed samples, by detex_tpu's rule
    (ds.build_bank): a template length that is not a multiple of nc gives
    the multiplexed form (make_bank); otherwise the overlap-save form when
    ``block_fft`` is given (block_fft=0 forces the full-length form), when
    ``prefer_os`` or when the full-length spectra would exceed
    OS_SPECTRA_BUDGET complex elements, and the full-length demuxed form
    (make_bank_demux) else or when the chunk is too short for one
    overlap-save block. Records ``pad_len``, the fixed chunk length.

    ``prefer_os`` defaults to True, what detex_tpu's engine and serving pass
    on its accelerator (detex_tpu's own default is False, ROADMAP C22). The
    overlap-save block is ``block_fft`` when given, else 2^bit_length(4*n_c)
    raised to os_min_block and snapped up to FUSED_BLOCK when the chunk's
    full-length FFT is at least that long (ROADMAP C1). ``pad_S`` pads the
    detector rows with all-zero templates (DS identically 0), ``min_dmax``
    the basis slots with masked zero slots (pad_rows, pad_dims)."""
    n = U_list[0].shape[1]
    if pad_S is not None and int(pad_S) > len(U_list):
        U_list = list(U_list) + [np.zeros((1, n), np.float64)] * (
            int(pad_S) - len(U_list))
    pad_len = int(data_len_samps)
    pad_len += (-pad_len) % nc
    if n % nc:
        nfft = required_fft_len(pad_len, n)
        bank = make_bank(U_list, nfft, device, min_dmax)
        bank.update(nfft=nfft, demux=False, nc=int(nc))
        bank["pad_len"] = pad_len
        return bank
    n_c = n // nc
    nfft2 = required_fft_len(pad_len // nc, n_c)
    Dmax = max(max(u.shape[0] for u in U_list), int(min_dmax))
    full_elems = len(U_list) * Dmax * nc * (nfft2 // 2 + 1)
    use_os = (block_fft if block_fft is not None
              else (prefer_os or full_elems > OS_SPECTRA_BUDGET))
    blk = 0
    if use_os:
        blk = int(block_fft) if block_fft else 2 ** int(4 * n_c).bit_length()
        while blk < os_min_block(n_c):
            blk *= 2
        if not block_fft and blk < FUSED_BLOCK and nfft2 >= FUSED_BLOCK:
            blk = FUSED_BLOCK
        blk = min(blk, nfft2)
        if blk < os_min_block(n_c):         # chunk too short for OS blocks
            blk = 0
    if blk:
        bank = make_bank_demux_os(U_list, nc, blk, device, min_dmax)
    else:
        bank = make_bank_demux(U_list, nc, nfft2, device, min_dmax)
    bank["pad_len"] = pad_len
    return bank


def bank_kind(bank):
    """"os" (overlap-save demuxed), "demux" (full-length demuxed) or "mux"
    (multiplexed); raises ValueError for a dict that is none of them."""
    if bank.get("os") and "blk_fft" in bank:
        return "os"
    if bank.get("demux") and "nfft2" in bank:
        return "demux"
    if not bank.get("demux") and "Ufd" in bank and "nfft" in bank:
        return "mux"
    raise ValueError("not an overlap-save, full-length demuxed or "
                     "multiplexed bank: keys %s" % sorted(bank))


def bank_from_numpy(d, device="cuda"):
    """The port's bank from a detex_tpu bank's arrays given as numpy (Ufd2,
    or Ufd for the multiplexed form, sum_u, d_mask) plus its int statics
    (blk_fft, nfft2 or nfft among them), so both packages compute with
    identical template spectra. Every bank form is carried; the statics
    present are copied (a dict of arrays alone gives arrays to update a
    bank with)."""
    key = "Ufd2" if "Ufd2" in d else "Ufd"
    out = {key: torch.tensor(np.asarray(d[key]).astype(np.complex64),
                             device=device),
           "sum_u": torch.tensor(np.asarray(d["sum_u"], np.float32),
                                 device=device),
           "d_mask": torch.tensor(np.asarray(d["d_mask"], bool),
                                  device=device),
           "demux": key == "Ufd2"}
    if d.get("os"):
        out["os"] = True
    for k in ("n", "n_c", "Dmax", "nc", "blk_fft", "nfft2", "nfft",
              "pad_len"):
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


def _safe_power(power):
    return torch.where(power == 0, torch.full_like(power, float("inf")),
                       power)


def _standardize(x):
    """(x - mean) / population std of one chunk x [Lc], sd 0 -> 1
    (detex_tpu ds.py:104-106, 200-202; ROADMAP C10)."""
    sd, mu = torch.std_mean(x, correction=0)
    return (x - mu) / torch.where(sd == 0, torch.ones_like(sd), sd)


def channel_sum(Ufd2, F):
    """sum_c Ufd2[..., c, :] * F[c, :]: the channel-summed cross-spectra
    [S, Dmax, R] of a demuxed bank Ufd2 [S, Dmax, nc, R] and a chunk's
    channel spectra F [nc, R] (detex_tpu's einsum "sdcr,cr->sdr"). A plain
    complex multiply-add, never a matrix product, so no TF32 setting of
    torch.backends reaches it (ROADMAP C5)."""
    out = Ufd2[:, :, 0] * F[0]
    for c in range(1, F.shape[0]):
        out += Ufd2[:, :, c] * F[c]
    return out


def ds_bank(x, Ufd, sum_u, d_mask, n, nc, nfft):
    """DS of one multiplexed chunk x [Lc] against a multiplexed bank
    (detex_tpu ds.ds_bank): [S, ceil((Lc - n + 1) / nc)], the statistic at
    every nc-th window start. No kernel, as in detex_tpu: the chunk's
    standardization, window stats, one rfft and one irfft per (template,
    basis row), then the finalize in torch. The window stats are
    rolling.window_stats_rows' (float64 sums and the exact zero-power rule,
    ROADMAP C23), not detex_tpu's float32 rolling means."""
    Lc = x.shape[0]
    xs = _standardize(x)
    a, power = window_stats_rows(xs[None, None], n, n)
    a, power = a[0, ::nc], power[0, ::nc]
    cc = _dft.irfft_full(Ufd * torch.fft.rfft(xs, nfft), nfft)
    y = cc[:, :, n - 1:Lc:nc] - sum_u[:, :, None] * a
    y = torch.where(d_mask[:, :, None], y, torch.zeros_like(y))
    return (y * y).sum(dim=1) / _safe_power(power)


def ds_single(x, Ufd, sum_u, n, nc, nfft):
    """DS of one multiplexed chunk x [Lc] against one subspace (detex_tpu
    ds.ds_single): Ufd [D, R] the spectra of its reversed basis
    (prep_basis_fd), sum_u [D]; the single-template case of ds_bank,
    [ceil((Lc - n + 1) / nc)]."""
    d_mask = torch.ones(1, Ufd.shape[0], dtype=torch.bool, device=Ufd.device)
    return ds_bank(x, Ufd[None], sum_u[None], d_mask, n, nc, nfft)[0]


def ds_bank_chunks(X, Ufd, sum_u, d_mask, n, nc, nfft):
    """ds_bank over a chunk batch X [B, Lc], one chunk at a time:
    [B, S, out_len]."""
    return torch.stack([ds_bank(x, Ufd, sum_u, d_mask, n, nc, nfft)
                        for x in X])


def demux_parts(x, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    """ds_bank_demux up to its finalize, for one multiplexed chunk x [Lc]:
    (cc [S, Dmax, L_c - n_c + 1], a, power [L_c - n_c + 1] with power 0 ->
    inf, su [S, Dmax] with masked slots 0), the inputs of
    cuda_kernels.ds_finalize. Population standardization of the whole
    chunk (ROADMAP C10), window stats by rolling.window_stats_rows, the
    channel rffts at nfft2, channel_sum and one irfft per (template, basis
    row)."""
    L_c = x.shape[0] // nc
    xc = _standardize(x)[:L_c * nc].reshape(L_c, nc).T      # [nc, L_c]
    a, power = window_stats_rows(xc[None], n_c, n_c * nc)
    spec = channel_sum(Ufd2, torch.fft.rfft(xc, nfft2, dim=-1))
    cc = _dft.irfft_full(spec, nfft2)[:, :, n_c - 1:L_c].contiguous()
    del spec
    su = torch.where(d_mask, sum_u, torch.zeros_like(sum_u)).contiguous()
    return cc, a[0].contiguous(), _safe_power(power[0]).contiguous(), su


def ds_bank_demux(x, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    """DS of one multiplexed chunk x [Lc] (Lc a multiple of nc) against a
    full-length demuxed bank (detex_tpu ds.ds_bank_demux):
    [S, Lc//nc - n_c + 1]. demux_parts, then one ds_finalize launch on
    the card."""
    return _ck.ds_finalize(*demux_parts(x, Ufd2, sum_u, d_mask, n_c, nc,
                                        nfft2))


def ds_bank_demux_chunks(X, Ufd2, sum_u, d_mask, n_c, nc, nfft2):
    """ds_bank_demux over a chunk batch X [B, Lc], one chunk at a time
    (detex_tpu's lax.map, _ds_map_demux): [B, S, out_len]."""
    return torch.stack([ds_bank_demux(x, Ufd2, sum_u, d_mask, n_c, nc,
                                      nfft2) for x in X])


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


# samples per segment of row_std_mean's first reduction
ROW_STAT_SEG = 4096


def row_std_mean(X):
    """Population std and mean of every row of a chunk batch X [B, L]
    (float32, [B, 1] each), the same bits whatever B is: std_mean over
    segments of ROW_STAT_SEG samples (one segment a reduction output, so
    that the library never splits a row's sum differently for another
    number of rows), then the segments' moments and the tail's combined in
    float64 (Chan's pairwise update)."""
    B, L = X.shape
    C = ROW_STAT_SEG
    K = L // C
    tail = X[:, K * C:].to(torch.float64)
    s1 = tail.sum(dim=1, keepdim=True)
    if K:
        sd, mu = torch.std_mean(X[:, :K * C].reshape(B, K, C), dim=-1,
                                correction=0)
        mu = mu.to(torch.float64)
        s1 = s1 + C * mu.sum(dim=1, keepdim=True)
    mean = s1 / L
    m2 = ((tail - mean) ** 2).sum(dim=1, keepdim=True)
    if K:
        m2 = m2 + C * (sd.to(torch.float64) ** 2 + (mu - mean) ** 2).sum(
            dim=1, keepdim=True)
    return (m2 / L).sqrt().to(torch.float32), mean.to(torch.float32)


def standardize_demux(X, n_c, nc, blk_fft):
    """The block input of both preps (fused and dense) from a chunk batch
    X [B, Lc] (float32 tensor): per-row standardization (mean and
    population std by row_std_mean, sd 0 -> 1), demuxed to [B, nc, L_c]
    with ``pad0`` leading zeros and zeros up to Lp = m*W + D0. Returns
    (xq [B, nc, Lp], out_len)."""
    B, Lc = X.shape
    L_c = Lc // nc
    out_len, pad0, D0, W, m = _os_geometry(L_c, n_c, blk_fft)
    sd, mu = row_std_mean(X)
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
    transform as a (real, imag) pair (dft.rfft_pair_frames: one
    rfft_ct_half launch on the card, the frames read in place)."""
    L_c = X.shape[1] // nc
    xq, _ = standardize_demux(X, n_c, nc, blk_fft)
    _, pad0, _, W, m = _os_geometry(L_c, n_c, blk_fft)
    a, power = window_stats_rows(xq[:, :, pad0:pad0 + L_c], n_c, n_c * nc)
    Rp = _dft.half_rp(blk_fft)
    fr, fi = _dft.rfft_pair_frames(xq, blk_fft, W, m, Rp)
    return fr.reshape(-1, m * Rp), fi.reshape(-1, m * Rp), a, power


def _pad_stats(a, power, out_len, width):
    """Window stats [..., out_len] padded to ``width`` (a = 0, power = 1
    past out_len) with power made safe (0 -> inf): the finalize's input."""
    pad_w = width - out_len
    pp = _safe_power(power)
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
    (dft.rfft_frames: one rfft_ct_fused launch on the card, the blocks
    read in place)."""
    L_c = X.shape[1] // nc
    xq, _ = standardize_demux(X, n_c, nc, blk_fft)
    _, pad0, _, W, m = _os_geometry(L_c, n_c, blk_fft)
    a, power = window_stats_rows(xq[:, :, pad0:pad0 + L_c], n_c, n_c * nc)
    return _dft.rfft_frames(xq, blk_fft, W, m), a, power


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
    the exact zero-power rule, exactly m frames at stride W,
    dft.rfft_frames)."""
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


# per bank_kind: the spectra's key, detex_tpu's static ``demux``, and the
# keys of the template length and of the transform length
BANK_FORMS = {"os": ("Ufd2", "os", "n_c", "blk_fft"),
              "demux": ("Ufd2", True, "n_c", "nfft2"),
              "mux": ("Ufd", False, "n", "nfft")}


def ds_of(x, arrs, demux, n_c, nc, nfft):
    """DS [S, out_len] of one chunk x [Lc] on a bank's arrays (Ufd2 or Ufd,
    sum_u, d_mask), by detex_tpu's static ``demux``: "os" ds_bank_demux_os,
    True ds_bank_demux, False ds_bank (``n_c`` is then the template length
    n)."""
    fn = (ds_bank_demux_os if demux == "os"
          else ds_bank_demux if demux else ds_bank)
    return fn(x, *arrs, n_c, int(nc), nfft)


def _ds_of_bank(x, bank, nc):
    """ds_of on a bank, on the bank's device."""
    spec, demux, n, nfft = BANK_FORMS[bank_kind(bank)]
    return ds_of(x, (bank[spec], bank["sum_u"], bank["d_mask"]), demux,
                 bank[n], nc, bank[nfft])


def _bank_batch_program(Xd, lens, bank, nc):
    """Run the bank over a device-resident chunk batch Xd [B, pad_len]
    with valid lengths ``lens`` (multiplexed samples). Returns (ds on the
    bank's device, lens). An overlap-save bank gives [B, S, m*W] with -inf
    past each valid length from the unfused batch, or, beyond
    fold_scan_supported or the inverse-block cap, [B, S, out_len] unmasked
    from a loop of ds_bank_demux_os over the chunks (detex_tpu's
    _ds_map_demux_os); full-length and multiplexed banks give [B, S,
    out_len] unmasked from a loop of ds_bank_demux or ds_bank (its
    _ds_map_demux, _ds_map_mux). Callers read each row up to its valid
    length."""
    pad_len = bank["pad_len"]
    if tuple(Xd.shape) != (len(lens), pad_len):
        raise ValueError("chunk batch %s does not match %d lengths x "
                         "pad_len %d" % (tuple(Xd.shape), len(lens), pad_len))
    if bank_kind(bank) == "os":
        n_c, blk = bank["n_c"], bank["blk_fft"]
        Dmax = int(bank["Dmax"])
        S = int(bank["sum_u"].shape[0])
        _, _, _, _, m = _os_geometry(pad_len // int(nc), n_c, blk)
        if (fold_scan_supported(n_c, blk)
                and len(lens) * S * Dmax * m * blk * 4 <= FOLD_CB_BYTES):
            nv = [max(_n_valid(L, bank, nc), 0) for L in lens]
            return _run_bank_batch_fold(
                Xd, nv, bank["Ufd2"], bank["sum_u"], bank["d_mask"], n_c,
                int(nc), blk), list(lens)
    return torch.stack([_ds_of_bank(x, bank, nc) for x in Xd]), list(lens)


def to_device(x, dev):
    """Chunks (numpy or a tensor) as float32 on ``dev``; a numpy array is
    spanned as "upload" and its bytes counted in h2d_bytes."""
    if not isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    with _trace.span("upload"):
        out = torch.as_tensor(x, dtype=torch.float32, device=dev)
    _trace.count("h2d_bytes", x.nbytes)
    return out


def to_host(t):
    """A tensor read back as numpy, spanned as "wait" (the read waits for
    the device's work behind it) and its bytes counted in d2h_bytes."""
    with _trace.span("wait"):
        out = t.cpu().numpy()
    _trace.count("d2h_bytes", out.nbytes)
    return out


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
    return to_device(xp, bank["sum_u"].device), Lc


def run_bank(x_np, bank, nc, pad_len=None):
    """Run a bank of any form over one host chunk, zero-padded to
    ``pad_len`` (default the bank's): a numpy [S, n_valid] DS array over
    the windows fully inside the real data (one bank run, one
    device-to-host copy)."""
    xp, Lc = _pad_chunk(x_np, bank, nc, pad_len)
    out = _ds_of_bank(xp, bank, nc)
    return to_host(out[:, :max(_n_valid(Lc, bank, nc), 0)])


def run_bank_rows(x_np, bank, nc, rows):
    """The DS rows ``rows`` of one host chunk from one bank run and one
    device-to-host copy of just those rows: {row_index: numpy float32
    [n_valid]}."""
    rows = [int(si) for si in rows]
    if not rows:
        return {}
    xp, Lc = _pad_chunk(x_np, bank, nc)
    out = _ds_of_bank(xp, bank, nc)
    nv = max(_n_valid(Lc, bank, nc), 0)
    sel = to_host(out[torch.as_tensor(rows, device=out.device), :nv])
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
    Xd = to_device(X, bank["sum_u"].device)
    return _bank_batch_program(Xd, lens, bank, nc)


def _n_valid(L, bank, nc):
    return (int(L) - bank["n"]) // int(nc) + 1


def run_bank_batch(x_list, bank, nc):
    """Run a bank over a list of host chunks in one batch: a list of numpy
    [S, n_valid_i] DS arrays, one per chunk."""
    if not x_list:
        return []
    out, lens = _bank_batch_out(x_list, bank, nc)
    out = to_host(out)
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
        got = dict(zip(jobs, to_host(sel)))
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
        packed = to_host(torch.cat([p.to(torch.float64) for p in parts],
                                   dim=1))
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
