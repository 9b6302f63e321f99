"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Marked ``cuda``: without a CUDA device every test skips. This file
imports neither jax nor detex_tpu, so it also runs where JAX is missing:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: spectra (bins <= blk/2) atol 2e-3; a atol 1e-4; power rtol 1e-4
/ atol 1e-3; pad values exact; ds and block maxima atol 2e-5 with -inf
positions identical; histogram row totals exact with at most one bin move
per 2e5 DS samples (edge-ULP moves, as tests/test_spec_ds.py calibrates);
inverse transforms within 2e-5 of the twin relative to the row's largest
value; trigger indices exact.
"""
import numpy as np
import pytest
import torch

import detex_torch
from detex_torch.ops import cuda_kernels as ck
from detex_torch.ops import dft
from detex_torch.ops import ds as tds
from detex_torch.ops import reference as ref
from detex_torch.parallel import scan as tscan

pytestmark = pytest.mark.cuda

NC = 3
LC = 3 * 35000
BLK = 16384
# (blk, n_c, L_c): 560 and 129 (the pad0 == 0 branch) at blk 16384, and
# 16300, the widest template the fused route takes at blk 32768
GEOMS = {"560": (BLK, 560, LC // NC), "129": (BLK, 129, LC // NC),
         "16300": (32768, 16300, 200000)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    detex_torch.require_cuda()
    return torch.device("cuda")


def _U_list(rng, S, D, n):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def _xq(rng, B, blk, n_c, L_c, device):
    out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    xq = torch.zeros((B, NC, m * W + D0), dtype=torch.float32, device=device)
    xq[:, :, pad0:pad0 + L_c] = torch.as_tensor(
        rng.standard_normal((B, NC, L_c)).astype(np.float32), device=device)
    # ragged last chunk: data ends late in frame 0, where the frame's
    # prefix sums are large
    xq[-1, :, pad0 + W - n_c // 2:] = 0.0
    return xq, out_len


@pytest.mark.parametrize("geom", ["560", "129", "16300"])
def test_fwd_prep_kernel_matches_twin(cuda, geom):
    blk, n_c, L_c = GEOMS[geom]
    xq, out_len = _xq(np.random.default_rng(n_c), 4, blk, n_c, L_c, cuda)
    k = ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)
    r = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    torch.cuda.synchronize()
    R = blk // 2 + 1
    m = k[0].shape[1] // dft.half_rp(blk)
    for a, b in zip(k[:2], r[:2]):
        a = a.reshape(a.shape[0], m, -1)
        b = b.reshape(b.shape[0], m, -1)
        assert (a[..., :R] - b[..., :R]).abs().max().item() <= 2e-3
        assert bool((a[..., R:] == 0).all())
    assert torch.allclose(k[2][:, :out_len], r[2][:, :out_len], rtol=0,
                          atol=1e-4)
    assert torch.allclose(k[3][:, :out_len], r[3][:, :out_len], rtol=1e-4,
                          atol=1e-3)
    assert bool((k[2][:, out_len:] == 0).all())
    assert bool((k[3][:, out_len:] == 1).all())


@pytest.mark.parametrize("mode,S,B,geom", [
    ("sub", 3, 8, "560"), ("net", 8, 4, "560"), ("sub", 1, 4, "16300"),
    ("net", 8, 4, "16300")])
@pytest.mark.parametrize("emit_ds", [True, False])
def test_spec_ds_kernel_matches_twin(cuda, mode, S, B, geom, emit_ds):
    blk, n_c, L_c = GEOMS[geom]
    rng = np.random.default_rng(S)
    bank = tds.build_bank(_U_list(rng, S, 3, NC * n_c), NC, NC * L_c, cuda,
                          block_fft=blk)
    X = torch.as_tensor(rng.standard_normal((B, NC * L_c)).astype(
        np.float32), device=cuda)
    _, _, D0, W, _ = tds._os_geometry(L_c, n_c, blk)
    Fr, Fi, a, p = tds.os_prep_batch_fused(X, n_c, NC, blk)
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.full((B,), L_c - n_c + 1, dtype=torch.int32, device=cuda)
    nv[1] = 0                                   # empty padded chunk
    nv[2] -= 20000                              # ragged chunk
    args = (ur, ui, Fr, Fi, a, p, su, nv, mode, NC, W, D0, blk)
    dk, pk, hk = ck.spec_ds_fold(*args, nbin=400, emit_ds=emit_ds)
    dr, pr, hr = ref.spec_ds_fold_ref(*args, nbin=400, emit_ds=emit_ds)
    torch.cuda.synchronize()
    assert torch.equal(torch.isfinite(pk), torch.isfinite(pr))
    fin = torch.isfinite(pr)
    assert (pk[fin] - pr[fin]).abs().max().item() <= 2e-5
    assert torch.equal(hk.sum(1), hr.sum(1))
    assert (hk - hr).abs().sum().item() <= hr.sum().item() // 200000
    if emit_ds:
        assert torch.equal(torch.isfinite(dk), torch.isfinite(dr))
        fin = torch.isfinite(dr)
        assert (dk[fin] - dr[fin]).abs().max().item() <= 2e-5
    else:
        assert dk is None and dr is None


@pytest.mark.parametrize("geom", ["560", "16300"])
def test_scan_runs_the_kernels(cuda, geom):
    """scan_chunks on the card launches both kernels and agrees with the
    same scan on the CPU twins."""
    blk, n_c, L_c = GEOMS[geom]
    n = NC * n_c
    rng = np.random.default_rng(9)
    U_list = _U_list(rng, 3, 4, n)
    X = rng.standard_normal((8, NC * L_c)).astype(np.float32)
    X[1, 5001:5001 + n] += 150.0 * U_list[0][0]
    th = np.full(3, 0.6, np.float32)
    out = {}
    for dev in ("cpu", cuda):
        bank = tds.build_bank(U_list, NC, NC * L_c, dev, block_fft=blk)
        ck.reset_launches()
        out[str(dev)] = [t.cpu() for t in tscan.scan_chunks(
            X, bank, th, NC, 250, max_trig=8)]
        launched = dict(ck.LAUNCHES)
    assert launched == {"fwd_prep_fold": 1, "spec_ds_fold": 1,
                        "ds_finalize_os_fold": 0, "rfft_ct_fused": 0,
                        "irfft_ct_fused": 0}
    c, g = out["cpu"], out[str(cuda)]
    assert torch.equal(c[0].sum(1), g[0].sum(1))
    assert (c[1] - g[1]).abs().max().item() <= 2e-5
    assert torch.equal(c[2], g[2]) and torch.equal(c[4], g[4])


@pytest.mark.parametrize("blk", [16384, 32768])
def test_block_transform_kernels_match_twins(cuda, blk):
    rng = np.random.default_rng(blk)
    x = torch.as_tensor(rng.standard_normal((40, blk)).astype(np.float32),
                        device=cuda)
    f = ck.rfft_ct_fused(x, blk)
    fr = ref.rfft_ct_fused_ref(x, blk)
    torch.cuda.synchronize()
    assert (f - fr).abs().max().item() <= 2e-3
    back = ck.irfft_ct_fused(fr, blk)
    want = ref.irfft_ct_fused_ref(fr, blk)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=1, keepdim=True)
    assert ((back - want).abs() / scale).max().item() <= 2e-5


@pytest.mark.parametrize("geom,nbin", [("560", 0), ("560", 400),
                                       ("16300", 400)])
def test_ds_finalize_kernel_matches_twin(cuda, geom, nbin):
    """ds_finalize_os_fold on the dense path's own inputs: three chunks
    (one empty, one ragged) against a 3-template bank."""
    blk, n_c, L_c = GEOMS[geom]
    rng = np.random.default_rng(n_c + nbin)
    S, D = 3, 3
    bank = tds.build_bank(_U_list(rng, S, D, NC * n_c), NC, NC * L_c, cuda,
                          block_fft=blk)
    X = torch.as_tensor(rng.standard_normal((3, NC * L_c)).astype(
        np.float32), device=cuda)
    F, a, power = tds.os_prep_batch(X, n_c, NC, blk)
    out_len, _, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    spec = sum(bank["Ufd2"][None, :, :, c, None, :] * F[:, None, None, c]
               for c in range(NC))
    cb = ref.irfft_ct_fused_ref(spec.reshape(-1, blk // 2 + 1), blk)
    pad = m * W - out_len
    ap = torch.nn.functional.pad(a, (0, pad))
    pp = torch.nn.functional.pad(power, (0, pad), value=1.0)
    su = torch.where(bank["d_mask"], bank["sum_u"],
                     torch.zeros_like(bank["sum_u"]))
    suf = su[None].expand(3, S, D).reshape(-1).contiguous()
    nv = torch.tensor([0, out_len - 5000, out_len], dtype=torch.int32,
                      device=cuda)
    args = (cb.reshape(3 * S * D, m, blk), ap, pp, suf, nv, D0, D, W, S)
    dk, pk, hk = ck.ds_finalize_os_fold(*args, nbin=nbin)
    dr, pr, hr = ref.ds_finalize_os_fold_ref(*args, nbin=nbin)
    torch.cuda.synchronize()
    for k, r in ((dk, dr), (pk, pr)):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert (k[fin] - r[fin]).abs().max().item() <= 2e-5
    if nbin:
        assert torch.equal(hk.sum(1), hr.sum(1))
        assert (hk - hr).abs().sum().item() <= max(hr.sum().item() // 200000,
                                                   2)


def test_dense_reverify_runs_the_kernels(cuda):
    """run_bank_triggers_batch on the card launches rfft_ct_fused,
    irfft_ct_fused and ds_finalize_os_fold once each and returns the CPU
    twins' triggers: indices exact, DS values within 2e-5."""
    blk, n_c, L_c = GEOMS["560"]
    n = NC * n_c
    rng = np.random.default_rng(10)
    U_list = _U_list(rng, 2, 3, n)
    X = rng.standard_normal((3, NC * L_c)).astype(np.float32)
    X[0, 3 * 9000:3 * 9000 + n] += 150.0 * U_list[0][0]
    X[2, 3 * 30000:3 * 30000 + n] += 150.0 * U_list[1][0]
    xs = [X[0], X[1][:NC * (L_c - 7000)], X[2]]
    rows, thrs = [[0, 1], [0], [1]], [[0.5, 0.5], [0.5], [0.5]]
    out = {}
    for dev in ("cpu", cuda):
        bank = tds.build_bank(U_list, NC, NC * L_c, dev, block_fft=blk)
        ck.reset_launches()
        out[str(dev)] = tds.run_bank_triggers_batch(
            xs, bank, NC, rows, thrs, [100.0] * 3, 5.0, 0.0, True)
        launched = dict(ck.LAUNCHES)
    assert launched == {"fwd_prep_fold": 0, "spec_ds_fold": 0,
                        "ds_finalize_os_fold": 1, "rfft_ct_fused": 1,
                        "irfft_ct_fused": 1}
    c, g = out["cpu"], out[str(cuda)]
    assert len(c[0][0][0]) == 1 and len(c[2][1][0]) == 1
    for ci in range(3):
        for si in rows[ci]:
            np.testing.assert_array_equal(c[ci][si][0], g[ci][si][0])
            np.testing.assert_allclose(g[ci][si][1], c[ci][si][1], rtol=0,
                                       atol=2e-5)
            np.testing.assert_allclose(g[ci][si][2], c[ci][si][2],
                                       rtol=1e-4)
