"""
Wrappers of the hand-written CUDA kernels (namesake of detex_tpu's
ops/pallas_kernels.py).

Each wrapper dispatches on the device of the tensors it is given: CPU
tensors go to the kernel's plain PyTorch twin (ops/reference.py), CUDA
tensors to the kernel, built at first use (kernels/build.py). A build or
launch failure raises; nothing falls back to the twin. ``LAUNCHES`` counts
kernel launches (twin calls are not counted) so a run can show that its main
path went through the kernels.

Kernels, the TPU kernel each replaces, and sources:

  fwd_prep_fold  pallas_kernels.py:1437  kernels/fwd_prep_fold.cu
  spec_ds_fold   pallas_kernels.py:1038  kernels/spec_ds_fold.cu
"""
from __future__ import annotations

import torch

from detex_torch.kernels import build as _build
from detex_torch.ops import dft as _dft
from detex_torch.ops import reference as _ref

LAUNCHES = {"fwd_prep_fold": 0, "spec_ds_fold": 0}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    _require(xq.dtype == torch.float32 and xq.is_contiguous(),
             "xq must be contiguous float32")
    _require(nc_ == nc, "xq has %d channels, expected %d" % (nc_, nc))
    _require(W >= 128 and W % 128 == 0 and n_c <= W,
             "geometry n_c=%d blk=%d not supported" % (n_c, blk))
    _require((Lp - D0) % W == 0 and Lp > D0,
             "Lp = %d is not m*W + D0 (W=%d, D0=%d)" % (Lp, W, D0))
    m = (Lp - D0) // W
    Rp = _dft.half_rp(blk)
    dev = xq.device
    fr = torch.empty((B * nc, m * Rp), dtype=torch.float32, device=dev)
    fi = torch.empty_like(fr)
    a = torch.empty((B, m * W), dtype=torch.float32, device=dev)
    power = torch.empty_like(a)
    tw = _dft.twiddles(blk, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.detex_fwd_prep_fold(
            _ptr(xq), _ptr(tw), _ptr(fr), _ptr(fi), _ptr(a), _ptr(power),
            B, nc, Lp, m, W, D0, pad0, n_c, int(out_len), Rp, log2m, stream)
    _build.check(lib, rc, "fwd_prep_fold")
    LAUNCHES["fwd_prep_fold"] += 1
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
    dev = fr.device
    BS = B * S
    ds = (torch.empty((BS, m * W), dtype=torch.float32, device=dev)
          if emit_ds else None)
    pyr = torch.empty((BS, m * (W // 128)), dtype=torch.float32, device=dev)
    hist = (torch.zeros((BS, nbin), dtype=torch.int32, device=dev)
            if nbin else None)
    tw = _dft.twiddles(blk, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.detex_spec_ds_fold(
            _ptr(ur), _ptr(ui), _ptr(fr), _ptr(fi), _ptr(a), _ptr(power),
            _ptr(sum_u), _ptr(nv), _ptr(tw), _ptr(ds), _ptr(pyr), _ptr(hist),
            B, S, D, nc, m, W, head, Rp, int(nbin), int(mode == "sub"),
            log2m, stream)
    _build.check(lib, rc, "spec_ds_fold")
    LAUNCHES["spec_ds_fold"] += 1
    return ds, pyr, hist
