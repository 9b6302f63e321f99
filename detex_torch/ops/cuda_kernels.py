"""
Wrappers of the hand-written CUDA kernels (namesake of detex_tpu's
ops/pallas_kernels.py).

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors go to the kernel's plain PyTorch twin (ops/reference.py), CUDA
tensors to the kernel, built at first use (kernels/build.py). A build or
launch failure raises; nothing falls back to the twin. ``LAUNCHES`` counts
kernel launches (twin calls are not counted) so a run can show that its main
path went through the kernels. Every block transform runs on the
register-resident FFT core of kernels/fft_regs.cuh: forward in
rfft_ct_fused, rfft_ct_half and fwd_prep_fold, inverse in irfft_ct_fused
and spec_ds_fold.

Kernels, the TPU kernel each replaces, and sources:

  fwd_prep_fold        pallas_kernels.py:1437  kernels/fwd_prep_fold.cu
  spec_ds_fold         pallas_kernels.py:1038  kernels/spec_ds_fold.cu
  ds_finalize_os_fold  pallas_kernels.py:575   kernels/ds_finalize_os_fold.cu
  rfft_ct_fused        pallas_kernels.py:336   kernels/rfft_ct.cu
  irfft_ct_fused       pallas_kernels.py:270   kernels/irfft_ct.cu
  rfft_ct_half         pallas_kernels.py:1223  kernels/rfft_ct_half.cu
  ds_finalize_os_scan  pallas_kernels.py:438   kernels/ds_finalize_os_scan.cu
  ds_finalize_os       pallas_kernels.py:701   kernels/ds_finalize_os.cu
  hist_uniform         pallas_kernels.py:199   kernels/hist_uniform.cu
  ds_finalize          pallas_kernels.py:104   kernels/ds_finalize.cu
"""
from __future__ import annotations

import torch

from detex_torch import trace as _trace
from detex_torch.kernels import build as _build
from detex_torch.ops import dft as _dft
from detex_torch.ops import reference as _ref

# trace.counters() reports these as "launches.<kernel>"
LAUNCHES = _trace.counter_group("launches", {
    "fwd_prep_fold": 0, "spec_ds_fold": 0, "ds_finalize_os_fold": 0,
    "rfft_ct_fused": 0, "irfft_ct_fused": 0, "rfft_ct_half": 0,
    "ds_finalize_os_scan": 0, "ds_finalize_os": 0, "hist_uniform": 0,
    "ds_finalize": 0})


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _count(kernel):
    """One launch of ``kernel``; sharded scans launch from several host
    threads, one a card."""
    _trace.count(kernel, counts=LAUNCHES)


def _on_cuda(*tensors):
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError("kernel operands on several devices: %s"
                         % sorted(map(str, devs)))
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError("no kernel for device %s" % dev)
    return True


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _log2m(blk):
    n1, _ = _dft._split(blk)
    _require(n1 == 128, "blk must be 16384 or 32768 (n1 == 128), got %d"
             % blk)
    return int(blk).bit_length() - 2


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fwd_prep_fold(xq, nc, n_c, blk, out_len):
    """Fused forward prep: demuxed standardized chunks xq [B, nc, Lp]
    (``pad0`` leading zeros, Lp = m*W + D0) -> (Fr, Fi [B*nc, m*Rp],
    a, power [B, m*W]). Semantics: reference.fwd_prep_fold_ref."""
    if not _on_cuda(xq):
        return _ref.fwd_prep_fold_ref(xq, nc, n_c, blk, out_len)
    log2m = _log2m(blk)
    pad0 = (-(n_c - 1)) % 128
    D0 = n_c - 1 + pad0
    W = blk - D0
    B, nc_, Lp = xq.shape
    _require(xq.dtype == torch.float32 and xq.is_contiguous()
             and xq.data_ptr() % 16 == 0,
             "xq must be contiguous float32 on a 16-byte boundary")
    _require(nc_ == nc, "xq has %d channels, expected %d" % (nc_, nc))
    _require(W >= 128 and W % 128 == 0 and n_c <= W,
             "geometry n_c=%d blk=%d not supported" % (n_c, blk))
    _require((Lp - D0) % W == 0 and Lp > D0,
             "Lp = %d is not m*W + D0 (W=%d, D0=%d)" % (Lp, W, D0))
    m = (Lp - D0) // W
    # the transforms read every channel's frames in place, 16 bytes a lane:
    # rows of Lp = m*W + D0 floats start on 16-byte boundaries because W
    # and D0 are multiples of 128
    _require(Lp % 4 == 0 and W % 4 == 0,
             "row length %d and stride %d must be multiples of 4 samples"
             % (Lp, W))
    Rp = _dft.half_rp(blk)
    dev = xq.device
    fr = torch.empty((B * nc, m * Rp), dtype=torch.float32, device=dev)
    fi = torch.empty_like(fr)
    a = torch.empty((B, m * W), dtype=torch.float32, device=dev)
    power = torch.empty_like(a)
    tw = _dft.twiddles(blk, dev)
    stage = _dft.stage_twiddles(blk, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.detex_fwd_prep_fold(
            _ptr(xq), _ptr(stage), _ptr(tw), _ptr(fr), _ptr(fi), _ptr(a), _ptr(power),
            B, nc, Lp, m, W, D0, pad0, n_c, int(out_len), Rp, log2m,
            _stream(dev))
    _build.check(lib, rc, "fwd_prep_fold")
    _count("fwd_prep_fold")
    return fr, fi, a, power


def spec_ds_fold(ur, ui, fr, fi, a, power, sum_u, nv, mode, nc, W, head, blk,
                 nbin=0, emit_ds=True):
    """One-pass spec -> DS scan: (ds [BS, m*W] or None, pyr
    [BS, m*(W//128)], hist [BS, nbin] int32 or None). Row order "net"
    (chunk, template) or "sub" (template, chunk). Semantics:
    reference.spec_ds_fold_ref."""
    if not _on_cuda(ur, ui, fr, fi, a, power, sum_u, nv):
        return _ref.spec_ds_fold_ref(ur, ui, fr, fi, a, power, sum_u, nv,
                                     mode, nc, W, head, blk, nbin=nbin,
                                     emit_ds=emit_ds)
    log2m = _log2m(blk)
    _require(mode in ("net", "sub"), "mode must be 'net' or 'sub'")
    D, S = sum_u.shape
    B = nv.shape[0]
    Rp = _dft.half_rp(blk)
    _require(head + W == blk and W % 128 == 0 and W // 128 <= 128,
             "geometry W=%d head=%d blk=%d not supported" % (W, head, blk))
    _require(D >= 1, "sum_u must hold at least one basis dim")
    _require(fr.shape[0] == B * nc and fr.shape[1] % Rp == 0,
             "fr shape %s does not match B=%d nc=%d Rp=%d"
             % (tuple(fr.shape), B, nc, Rp))
    m = fr.shape[1] // Rp
    _require(tuple(ur.shape) == (D, S, nc, Rp) and ui.shape == ur.shape,
             "ur/ui must be [D, S, nc, Rp] = %s" % ((D, S, nc, Rp),))
    _require(fi.shape == fr.shape and tuple(a.shape) == (B, m * W)
             and power.shape == a.shape, "fi/a/power shapes do not match")
    for t in (ur, ui, fr, fi, a, power, sum_u):
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 "spectra, stats and sum_u must be contiguous float32")
    _require(nv.dtype == torch.int32 and nv.is_contiguous(),
             "nv must be contiguous int32")
    # the kernel reads the stats four positions a load
    _require(a.data_ptr() % 16 == 0 and power.data_ptr() % 16 == 0,
             "a and power must start on 16-byte boundaries")
    dev = fr.device
    BS = B * S
    ds = (torch.empty((BS, m * W), dtype=torch.float32, device=dev)
          if emit_ds else None)
    pyr = torch.empty((BS, m * (W // 128)), dtype=torch.float32, device=dev)
    hist = (torch.zeros((BS, nbin), dtype=torch.int32, device=dev)
            if nbin else None)
    tw = _dft.twiddles(blk, dev)
    stage = _dft.stage_twiddles(blk, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.detex_spec_ds_fold(
            _ptr(ur), _ptr(ui), _ptr(fr), _ptr(fi), _ptr(a), _ptr(power),
            _ptr(sum_u), _ptr(nv), _ptr(stage), _ptr(tw), _ptr(ds), _ptr(pyr), _ptr(hist),
            B, S, D, nc, m, W, head, Rp, int(nbin), int(mode == "sub"),
            log2m, _stream(dev))
    _build.check(lib, rc, "spec_ds_fold")
    _count("spec_ds_fold")
    return ds, pyr, hist


def _frame_source(x, n, stride, frames, name):
    """Checks of a forward transform's source x [R, Lp]: ``frames`` frames
    of n samples at stride ``stride`` per row (contiguous [N, n] rows when
    ``stride`` is None), every frame on a 16-byte boundary. Returns
    (Lp, m, W)."""
    _require(x.dim() == 2, "%s: x must be two-dimensional, got %s"
             % (name, tuple(x.shape)))
    Lp = x.shape[1]
    if stride is None:
        _require(frames == 1 and Lp == n,
                 "%s: x must be [N, %d], got %s" % (name, n, tuple(x.shape)))
        return Lp, 1, n
    m, W = int(frames), int(stride)
    _require(m >= 1 and W >= 1 and (m - 1) * W + n <= Lp,
             "%s: %d frames of %d at stride %d do not fit rows of %d"
             % (name, m, n, W, Lp))
    _require(W % 4 == 0 and Lp % 4 == 0,
             "%s: stride %d and row length %d must be multiples of 4 "
             "samples (frames start on 16-byte boundaries)" % (name, W, Lp))
    return Lp, m, W


def _frame_view(x, n, m, W):
    """The frames as rows [R*m, n] (a copy unless the rows are [N, n])."""
    return x.unfold(1, n, W)[:, :m].reshape(-1, n)


def rfft_ct_fused(x, n, stride=None, frames=1):
    """Forward real DFT of float32 rows of n samples (n = 16384 or 32768
    on the card): complex64 [N, n//2 + 1], bins 0..n/2 in natural order.
    x is [N, n], or with ``stride`` [R, Lp] holding ``frames`` frames of n
    samples at that stride per row, read in place (frame f of row r is
    output row r*frames + f). Semantics: reference.rfft_ct_fused_ref."""
    Lp, m, W = _frame_source(x, n, stride, frames, "rfft_ct_fused")
    if not _on_cuda(x):
        return _ref.rfft_ct_fused_ref(_frame_view(x, n, m, W), n)
    log2m = _log2m(n)
    _require(x.dtype == torch.float32 and x.is_contiguous()
             and x.data_ptr() % 16 == 0,
             "x must be contiguous float32 on a 16-byte boundary")
    N = x.shape[0] * m
    out = torch.empty((N, n // 2 + 1), dtype=torch.complex64,
                      device=x.device)
    if N == 0:
        return out
    tw = _dft.twiddles(n, x.device)
    stage = _dft.stage_twiddles(n, x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.detex_rfft_ct(_ptr(x), _ptr(stage), _ptr(tw), _ptr(out), N,
                               Lp, m, W, log2m, _stream(x.device))
    _build.check(lib, rc, "rfft_ct_fused")
    _count("rfft_ct_fused")
    return out


def irfft_ct_fused(spec, n):
    """Inverse real DFT of every half spectrum spec [N, n//2 + 1]
    complex64 (n = 16384 or 32768 on the card): float32 [N, n] scaled by
    1/n. Semantics: reference.irfft_ct_fused_ref."""
    if not _on_cuda(spec):
        return _ref.irfft_ct_fused_ref(spec, n)
    log2m = _log2m(n)
    _require(spec.dim() == 2 and spec.shape[1] == n // 2 + 1,
             "spec must be [N, %d], got %s" % (n // 2 + 1, tuple(spec.shape)))
    _require(spec.dtype == torch.complex64 and spec.is_contiguous(),
             "spec must be contiguous complex64")
    N = spec.shape[0]
    out = torch.empty((N, n), dtype=torch.float32, device=spec.device)
    if N == 0:
        return out
    tw = _dft.twiddles(n, spec.device)
    stage = _dft.stage_twiddles(n, spec.device)
    lib = _build.load_library()
    with torch.cuda.device(spec.device):
        rc = lib.detex_irfft_ct(_ptr(spec), _ptr(stage), _ptr(tw), _ptr(out),
                                N, log2m, _stream(spec.device))
    _build.check(lib, rc, "irfft_ct_fused")
    _count("irfft_ct_fused")
    return out


def ds_finalize_os_fold(cb, a, power, sum_u, nv, head, D, W, group=1,
                        nbin=0):
    """DS finalize of raw overlap-save inverse blocks cb [BS*D, m, blk]
    with window stats a, power [BS/group, m*W] (DS row r reads stats row
    r // group), basis sums sum_u [BS*D] and valid lengths nv [BS/group]
    int32: (ds [BS, m*W], pyr [BS, m*W/128], hist [BS, nbin] int32 or
    None). Semantics: reference.ds_finalize_os_fold_ref."""
    if not _on_cuda(cb, a, power, sum_u, nv):
        return _ref.ds_finalize_os_fold_ref(cb, a, power, sum_u, nv, head,
                                            D, W, group=group, nbin=nbin)
    BSD, m, blk = cb.shape
    _require(D >= 1 and BSD % D == 0, "cb rows %d not a multiple of D=%d"
             % (BSD, D))
    BS = BSD // D
    _require(group >= 1 and BS % group == 0,
             "%d DS rows are not groups of %d" % (BS, group))
    G = BS // group
    _require(W % 128 == 0 and W >= 128 and 0 <= head and head + W <= blk,
             "geometry W=%d head=%d blk=%d not supported" % (W, head, blk))
    _require(tuple(a.shape) == (G, m * W) and power.shape == a.shape,
             "a / power must be [%d, %d]" % (G, m * W))
    _require(tuple(sum_u.shape) == (BSD,), "sum_u must be [BS*D]")
    _require(tuple(nv.shape) == (G,), "nv must be [%d]" % G)
    for t in (cb, a, power, sum_u):
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 "cb, stats and sum_u must be contiguous float32")
    _require(nv.dtype == torch.int32 and nv.is_contiguous(),
             "nv must be contiguous int32")
    dev = cb.device
    ds = torch.empty((BS, m * W), dtype=torch.float32, device=dev)
    pyr = torch.empty((BS, m * (W // 128)), dtype=torch.float32, device=dev)
    hist = (torch.zeros((BS, nbin), dtype=torch.int32, device=dev)
            if nbin else None)
    if BS * m == 0:
        return ds, pyr, hist
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.detex_ds_finalize_os_fold(
            _ptr(cb), _ptr(a), _ptr(power), _ptr(sum_u), _ptr(nv), _ptr(ds),
            _ptr(pyr), _ptr(hist), BS, D, m, blk, W, head, int(group),
            int(nbin), _stream(dev))
    _build.check(lib, rc, "ds_finalize_os_fold")
    _count("ds_finalize_os_fold")
    return ds, pyr, hist


def rfft_ct_half(x, n, stride=None, frames=1):
    """Forward real DFT of float32 rows of n samples (n = 16384 or 32768
    on the card) as the padded half-spectrum pair (fr, fi)
    [N, dft.half_rp(n)] float32, zeros past n//2. x is [N, n], or with
    ``stride`` [R, Lp] holding ``frames`` frames per row, read in place,
    as rfft_ct_fused. Semantics: reference.rfft_ct_half_ref."""
    Lp, m, W = _frame_source(x, n, stride, frames, "rfft_ct_half")
    if not _on_cuda(x):
        return _ref.rfft_ct_half_ref(_frame_view(x, n, m, W), n)
    log2m = _log2m(n)
    _require(x.dtype == torch.float32 and x.is_contiguous()
             and x.data_ptr() % 16 == 0,
             "x must be contiguous float32 on a 16-byte boundary")
    N = x.shape[0] * m
    Rp = _dft.half_rp(n)
    fr = torch.empty((N, Rp), dtype=torch.float32, device=x.device)
    fi = torch.empty_like(fr)
    if N == 0:
        return fr, fi
    tw = _dft.twiddles(n, x.device)
    stage = _dft.stage_twiddles(n, x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        rc = lib.detex_rfft_ct_half(_ptr(x), _ptr(stage), _ptr(tw), _ptr(fr),
                                    _ptr(fi), N, Lp, m, W, Rp, log2m,
                                    _stream(x.device))
    _build.check(lib, rc, "rfft_ct_half")
    _count("rfft_ct_half")
    return fr, fi


def _check_os_block(cb, a, power, sum_u, D, W, head):
    """Shared checks of the per-chunk finalize kernels; returns (S, m)."""
    SD, m, blk = cb.shape
    _require(D >= 1 and SD % D == 0, "cb rows %d not a multiple of D=%d"
             % (SD, D))
    _require(W % 128 == 0 and W >= 128 and 0 <= head and head + W <= blk,
             "geometry W=%d head=%d blk=%d not supported" % (W, head, blk))
    _require(tuple(a.shape) == (m * W,) and power.shape == a.shape,
             "a / power must be [%d]" % (m * W))
    _require(tuple(sum_u.shape) == (SD,), "sum_u must be [S*D]")
    for t in (cb, a, power, sum_u):
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 "cb, stats and sum_u must be contiguous float32")
    # the kernels read cb and the stats four positions a load
    _require(head % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in (cb, a, power)),
             "head must be a multiple of 4 and cb, a, power start on "
             "16-byte boundaries")
    return SD // D, m


def ds_finalize_os_scan(cb, a, power, sum_u, nv, head, D, W, nbin=0):
    """Per-chunk DS finalize of raw overlap-save inverse blocks
    cb [S*D, m, blk] with the chunk's window stats a, power [m*W], basis
    sums sum_u [S*D] and valid length nv (one int32 on the device):
    (ds [S, m*W], pyr [S, m*W/128], hist [S, nbin] int32 or None).
    Semantics: reference.ds_finalize_os_scan_ref."""
    if not _on_cuda(cb, a, power, sum_u, nv):
        return _ref.ds_finalize_os_scan_ref(cb, a, power, sum_u, nv, head,
                                            D, W, nbin=nbin)
    S, m = _check_os_block(cb, a, power, sum_u, D, W, head)
    _require(nv.numel() == 1 and nv.dtype == torch.int32
             and nv.is_contiguous(), "nv must be one contiguous int32")
    dev = cb.device
    ds = torch.empty((S, m * W), dtype=torch.float32, device=dev)
    pyr = torch.empty((S, m * (W // 128)), dtype=torch.float32, device=dev)
    hist = (torch.zeros((S, nbin), dtype=torch.int32, device=dev)
            if nbin else None)
    if S * m == 0:
        return ds, pyr, hist
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.detex_ds_finalize_os_scan(
            _ptr(cb), _ptr(a), _ptr(power), _ptr(sum_u), _ptr(nv), _ptr(ds),
            _ptr(pyr), _ptr(hist), S, D, m, cb.shape[2], W, head, int(nbin),
            _stream(dev))
    _build.check(lib, rc, "ds_finalize_os_scan")
    _count("ds_finalize_os_scan")
    return ds, pyr, hist


def ds_finalize_os(cb, a, power, sum_u, head, D, W):
    """Per-chunk DS finalize without mask, maxima or histogram: ds
    [S, m*W] from cb [S*D, m, blk], a, power [m*W] (a = 0, power = 1 past
    the valid length) and sum_u [S*D]; on the card head % 4 == 0 and cb,
    a, power start on 16-byte boundaries, as for ds_finalize_os_scan.
    Semantics: reference.ds_finalize_os_ref."""
    if not _on_cuda(cb, a, power, sum_u):
        return _ref.ds_finalize_os_ref(cb, a, power, sum_u, head, D, W)
    S, m = _check_os_block(cb, a, power, sum_u, D, W, head)
    dev = cb.device
    ds = torch.empty((S, m * W), dtype=torch.float32, device=dev)
    if S * m == 0:
        return ds
    lib = _build.load_library()
    with torch.cuda.device(dev):
        rc = lib.detex_ds_finalize_os(
            _ptr(cb), _ptr(a), _ptr(power), _ptr(sum_u), _ptr(ds), S, D, m,
            cb.shape[2], W, head, _stream(dev))
    _build.check(lib, rc, "ds_finalize_os")
    _count("ds_finalize_os")
    return ds


def hist_uniform(ds, nbin):
    """Per-row floor-rule histogram of ds [S, L] float32 over [0, 1] in
    ``nbin`` uniform bins: int32 [S, nbin]. Semantics:
    reference.hist_uniform_ref."""
    if not _on_cuda(ds):
        return _ref.hist_uniform_ref(ds, nbin)
    _require(ds.dim() == 2 and ds.dtype == torch.float32
             and ds.is_contiguous(), "ds must be contiguous float32 [S, L]")
    _require(nbin >= 1, "nbin must be positive, got %d" % nbin)
    S, L = ds.shape
    hist = torch.zeros((S, nbin), dtype=torch.int32, device=ds.device)
    if S * L == 0:
        return hist
    lib = _build.load_library()
    with torch.cuda.device(ds.device):
        rc = lib.detex_hist_uniform(_ptr(ds), _ptr(hist), S, L, int(nbin),
                                    _stream(ds.device))
    _build.check(lib, rc, "hist_uniform")
    _count("hist_uniform")
    return hist


def ds_finalize(cc, a, power, sum_u):
    """Full-length DS finalize: ds [S, L] = sum_d (cc - sum_u * a)^2 /
    power from cc [S, D, L], a, power [L] (power made safe by the caller:
    inf where 0) and sum_u [S, D] (0 on masked slots). Semantics:
    reference.ds_finalize_ref."""
    if not _on_cuda(cc, a, power, sum_u):
        return _ref.ds_finalize_ref(cc, a, power, sum_u)
    _require(cc.dim() == 3, "cc must be [S, D, L], got %s"
             % (tuple(cc.shape),))
    S, D, L = cc.shape
    _require(tuple(a.shape) == (L,) and power.shape == a.shape,
             "a / power must be [%d]" % L)
    _require(tuple(sum_u.shape) == (S, D), "sum_u must be [%d, %d]" % (S, D))
    for t in (cc, a, power, sum_u):
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 "cc, stats and sum_u must be contiguous float32")
    ds = torch.empty((S, L), dtype=torch.float32, device=cc.device)
    if S * L == 0:
        return ds
    lib = _build.load_library()
    with torch.cuda.device(cc.device):
        rc = lib.detex_ds_finalize(_ptr(cc), _ptr(a), _ptr(power),
                                   _ptr(sum_u), _ptr(ds), S, D, L,
                                   _stream(cc.device))
    _build.check(lib, rc, "ds_finalize")
    _count("ds_finalize")
    return ds
