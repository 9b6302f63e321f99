"""The hand-written CUDA kernels against their plain PyTorch twins, and the
template-blocked scan and the detection engine against their CPU runs, on
the card. Marked ``cuda``: without a CUDA device every test skips but the
engine's refusal to run on "cuda" without one. This file imports neither
jax nor detex_tpu, so it also runs where JAX is missing:

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
from detex_torch.ops import prep as tprep
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
_NONE = dict.fromkeys(ck.LAUNCHES, 0)


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


def _spec_args(cuda, mode, S, D, B, blk, n_c, L_c, seed):
    """spec_ds_fold's arguments from the fused prep of B chunks of noise
    against S templates of D dims each; chunk 0 ragged."""
    rng = np.random.default_rng(seed)
    U_list = [np.ascontiguousarray(np.linalg.qr(
        rng.standard_normal((NC * n_c, D)))[0].T) for _ in range(S)]
    bank = tds.build_bank(U_list, NC, NC * L_c, cuda, block_fft=blk)
    X = torch.as_tensor(rng.standard_normal((B, NC * L_c)).astype(
        np.float32), device=cuda)
    _, _, D0, W, _ = tds._os_geometry(L_c, n_c, blk)
    Fr, Fi, a, p = tds.os_prep_batch_fused(X, n_c, NC, blk)
    ur, ui = tds.bank_spec_pair(bank)
    su = bank["sum_u"].T.contiguous()
    nv = torch.full((B,), L_c - n_c + 1, dtype=torch.int32, device=cuda)
    nv[0] -= n_c                                # ragged chunk
    return (ur, ui, Fr, Fi, a, p, su, nv, mode, NC, W, D0, blk)


# (mode, S, D, B, L_c): one thread block (one template leaves the second
# transform of the block without work); a grid of 144 blocks, one wave of
# the card's 132 SMs and a ragged second, with dims paired (D = 3, the last
# step half empty) and with templates paired (D = 1)
SPEC_WAVES = [("net", 1, 1, 1, 8000), ("sub", 1, 2, 1, 8000),
              ("sub", 3, 3, 16, 35000), ("net", 8, 1, 12, 35000)]


@pytest.mark.parametrize("mode,S,D,B,L_c", SPEC_WAVES)
def test_spec_ds_kernel_waves_and_repeatable_bits(cuda, mode, S, D, B, L_c):
    """spec_ds_fold at one block of work and at a ragged last wave against
    its twin, and two launches on the same inputs give identical bits (the
    sums inside a block are ordered by barriers, never by atomics on
    floats)."""
    args = _spec_args(cuda, mode, S, D, B, BLK, 560, L_c, S + D + B)
    d1, p1, h1 = ck.spec_ds_fold(*args, nbin=400, emit_ds=True)
    d2, p2, h2 = ck.spec_ds_fold(*args, nbin=400, emit_ds=True)
    dr, pr, hr = ref.spec_ds_fold_ref(*args, nbin=400, emit_ds=True)
    torch.cuda.synchronize()
    # equal bits, -inf and all: compare the words
    for u, v in ((d1, d2), (p1, p2)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    assert torch.equal(h1, h2)
    for k, r in ((d1, dr), (p1, pr)):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert fin.any() and (k[fin] - r[fin]).abs().max().item() <= 2e-5
    assert torch.equal(h1.sum(1), hr.sum(1))
    assert (h1 - hr).abs().sum().item() <= max(1, hr.sum().item() // 200000)


@pytest.mark.parametrize("B,L_c", [(1, 8000), (100, 35000)])
def test_fwd_prep_kernel_waves(cuda, B, L_c):
    """fwd_prep_fold at one thread block (one chunk of one frame) and at
    300 blocks, one wave of 264 resident blocks and a ragged second,
    against its twin."""
    n_c = 560
    xq, out_len = _xq(np.random.default_rng(B), B, BLK, n_c, L_c, cuda)
    k = ck.fwd_prep_fold(xq, NC, n_c, BLK, out_len)
    r = ref.fwd_prep_fold_ref(xq, NC, n_c, BLK, out_len)
    torch.cuda.synchronize()
    R = BLK // 2 + 1
    m = k[0].shape[1] // dft.half_rp(BLK)
    assert B * m == (1 if B == 1 else 300)
    for u, v in zip(k[:2], r[:2]):
        u = u.reshape(u.shape[0], m, -1)
        v = v.reshape(v.shape[0], m, -1)
        assert (u[..., :R] - v[..., :R]).abs().max().item() <= 2e-3
        assert bool((u[..., R:] == 0).all())
    assert torch.allclose(k[2][:, :out_len], r[2][:, :out_len], rtol=0,
                          atol=1e-4)
    assert torch.allclose(k[3][:, :out_len], r[3][:, :out_len], rtol=1e-4,
                          atol=1e-3)
    assert bool((k[2][:, out_len:] == 0).all())
    assert bool((k[3][:, out_len:] == 1).all())


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
    assert launched == dict(_NONE, fwd_prep_fold=1, spec_ds_fold=1)
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


@pytest.mark.parametrize("N,blk", [(1, 16384), (3584, 16384), (1, 32768),
                                   (1792, 32768)])
def test_irfft_ct_kernel_rows_match_twin(cuda, N, blk):
    """irfft_ct_fused (B5, on the register core's inverse) on one row and
    at the per-chunk route's rows (one D2 chunk: 3,584 of 16,384; one D1
    chunk: 1,792 of 32,768), an all-zero row among them: within 2e-5 of
    the twin relative to each row's largest value, the zero row exactly 0,
    one launch."""
    g = torch.Generator(device=cuda).manual_seed(N + blk)
    spec = torch.view_as_complex(torch.randn((N, blk // 2 + 1, 2),
                                             generator=g, device=cuda))
    # real end bins, as every caller's spectra have them
    torch.view_as_real(spec)[:, [0, -1], 1] = 0.0
    if N > 1:
        spec[7] = 0
    ck.reset_launches()
    back = ck.irfft_ct_fused(spec, blk)
    assert ck.LAUNCHES == dict(_NONE, irfft_ct_fused=1)
    want = ref.irfft_ct_fused_ref(spec, blk)
    torch.cuda.synchronize()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    assert ((back - want).abs() / scale).max().item() <= 2e-5
    if N > 1:
        assert bool((back[7] == 0).all())


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
    assert launched == dict(_NONE, ds_finalize_os_fold=1, rfft_ct_fused=1,
                            irfft_ct_fused=1)
    c, g = out["cpu"], out[str(cuda)]
    assert len(c[0][0][0]) == 1 and len(c[2][1][0]) == 1
    for ci in range(3):
        for si in rows[ci]:
            np.testing.assert_array_equal(c[ci][si][0], g[ci][si][0])
            np.testing.assert_allclose(g[ci][si][1], c[ci][si][1], rtol=0,
                                       atol=2e-5)
            np.testing.assert_allclose(g[ci][si][2], c[ci][si][2],
                                       rtol=1e-4)


def test_fwd_prep_kernel_zero_power_rule(cuda):
    """fwd_prep_fold's exact zero-power rule on the card: zero-filled gaps
    longer than the template (one across a frame boundary) and a stretch
    where every channel holds one constant give power inf where the twin
    does; a stretch of per-channel constants keeps a finite power."""
    blk, n_c, L_c = GEOMS["560"]
    xq, out_len = _xq(np.random.default_rng(5), 2, blk, n_c, L_c, cuda)
    _, pad0, _, W, _ = tds._os_geometry(L_c, n_c, blk)
    g = 2 * n_c + 50
    x0 = xq[0, :, pad0:]
    x0[:, 40:40 + g] = 0.0
    x0[:, W - n_c:W + n_c + 7] = 0.0
    x0[:, 3000:3000 + g] = 0.7
    x0[0, 2999] = 0.7
    x0[:, 6000:6000 + g] = torch.tensor([[0.1], [0.2], [0.3]], device=cuda)
    k = ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)[3][:, :out_len]
    r = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)[3][:, :out_len]
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(k), torch.isinf(r))
    assert int(torch.isinf(r[0]).sum()) == 2 * (g - n_c + 1) + n_c + 8
    fin = torch.isfinite(r)
    assert torch.allclose(k[fin], r[fin], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("blk", [16384, 32768])
def test_rfft_ct_half_kernel_matches_twin(cuda, blk):
    rng = np.random.default_rng(blk + 2)
    x = torch.as_tensor(rng.standard_normal((40, blk)).astype(np.float32),
                        device=cuda)
    k = ck.rfft_ct_half(x, blk)
    r = ref.rfft_ct_half_ref(x, blk)
    torch.cuda.synchronize()
    R = blk // 2 + 1
    for a, b in zip(k, r):
        assert (a[:, :R] - b[:, :R]).abs().max().item() <= 2e-3
        assert bool((a[:, R:] == 0).all())


def _os_block_args(cuda, blk, n_c, L_c, S, D, seed):
    """One chunk's per-chunk finalize inputs, made as ds._os_block makes
    them (twin transforms): (cb [S*D, m, blk], a, power [m*W], su, D0, W,
    out_len)."""
    rng = np.random.default_rng(seed)
    bank = tds.build_bank(_U_list(rng, S, D, NC * n_c), NC, NC * L_c, cuda,
                          block_fft=blk)
    x = torch.as_tensor(rng.standard_normal(NC * L_c).astype(np.float32),
                        device=cuda)
    out_len, _, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    xq, _ = tds.standardize_demux(x[None], n_c, NC, blk)
    F = ref.rfft_ct_fused_ref(xq[0].unfold(1, blk, W), blk)
    a, power = tds.window_stats_rows(
        xq[:, :, (-(n_c - 1)) % 128:][:, :, :L_c], n_c, n_c * NC)
    spec = sum(bank["Ufd2"][:, :, c, None, :] * F[c][None, None]
               for c in range(NC))
    cb = ref.irfft_ct_fused_ref(spec.reshape(-1, blk // 2 + 1), blk)
    ap, pp = tds._pad_stats(a[0], power[0], out_len, m * W)
    su = torch.where(bank["d_mask"], bank["sum_u"],
                     torch.zeros_like(bank["sum_u"])).reshape(-1)
    return cb.reshape(S * D, m, blk), ap, pp, su.contiguous(), D0, W, out_len


@pytest.mark.parametrize("nbin,ragged", [(0, False), (400, True),
                                         (400, False)])
def test_ds_finalize_os_scan_kernel_matches_twin(cuda, nbin, ragged):
    S, D = 5, 3
    cb, a, p, su, D0, W, out_len = _os_block_args(cuda, BLK, 560, 60000, S,
                                                  D, nbin + ragged)
    nv = torch.tensor([out_len - 20000 if ragged else out_len],
                      dtype=torch.int32, device=cuda)
    args = (cb, a, p, su, nv, D0, D, W)
    dk, pk, hk = ck.ds_finalize_os_scan(*args, nbin=nbin)
    dr, pr, hr = ref.ds_finalize_os_scan_ref(*args, nbin=nbin)
    torch.cuda.synchronize()
    for k, r in ((dk, dr), (pk, pr)):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert (k[fin] - r[fin]).abs().max().item() <= 2e-5
    if nbin:
        assert torch.equal(hk.sum(1), hr.sum(1))
        assert (hk - hr).abs().sum().item() <= max(hr.sum().item() // 200000,
                                                   2)
    else:
        assert hk is None and hr is None


def test_ds_finalize_os_scan_kernel_d2_shape_repeatable_bits(cuda):
    """ds_finalize_os_scan (B7) at one D2 chunk's shape (128 one-dim 30 s
    templates, 28 blocks of 16,384, W 13,312) on noise, whose DS puts
    nearly every sample into bin 0: against its twin, and two launches
    give identical bits (every sample is one thread's; the counts are
    integer atomics)."""
    cb, a, p, su, D0, W, out_len = _os_block_args(cuda, BLK, 3000, 372000,
                                                  128, 1, 3)
    assert tuple(cb.shape) == (128, 28, BLK) and W == 13312
    nv = torch.tensor([out_len], dtype=torch.int32, device=cuda)
    args = (cb, a, p, su, nv, D0, 1, W)
    d1, p1, h1 = ck.ds_finalize_os_scan(*args, nbin=400)
    d2, p2, h2 = ck.ds_finalize_os_scan(*args, nbin=400)
    dr, pr, hr = ref.ds_finalize_os_scan_ref(*args, nbin=400)
    torch.cuda.synchronize()
    for u, v in ((d1, d2), (p1, p2)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))
    assert torch.equal(h1, h2)
    for k, r in ((d1, dr), (p1, pr)):
        assert torch.equal(torch.isfinite(k), torch.isfinite(r))
        fin = torch.isfinite(r)
        assert (k[fin] - r[fin]).abs().max().item() <= 2e-5
    assert torch.equal(h1.sum(1), hr.sum(1))
    assert int(h1.sum(1)[0]) == out_len
    assert (h1 - hr).abs().sum().item() <= max(hr.sum().item() // 200000, 2)
    assert int(hr[:, 0].sum()) >= 0.9 * int(hr.sum())


# (blk, n_c, L_c, S, D): the ids "16384" and "32768" are the cases the test
# had before the others; "d1-chunk" is one D1 chunk (128 one-dim 60 s
# templates on 3720 s, cb [128, 14, 32768]); "D5" the general form
OS_CASES = {"16384": (16384, 560, 60000, 4, 2),
            "32768": (32768, 560, 60000, 4, 2),
            "d1-chunk": (32768, 6000, 372000, 128, 1),
            "D5": (16384, 560, 60000, 3, 5)}


@pytest.mark.parametrize("case", list(OS_CASES))
def test_ds_finalize_os_and_hist_kernels_match_twins(cuda, case):
    """ds_finalize_os on one chunk's inverse blocks, then hist_uniform on
    its DS rows with a ragged -inf tail and exact 1.0 values (counts
    equal to the twin's: the same float32 floor rule)."""
    blk, n_c, L_c, S, D = OS_CASES[case]
    cb, a, p, su, D0, W, out_len = _os_block_args(cuda, blk, n_c, L_c, S,
                                                  D, blk + D - 2)
    dk = ck.ds_finalize_os(cb, a, p, su, D0, D, W)
    dr = ref.ds_finalize_os_ref(cb, a, p, su, D0, D, W)
    torch.cuda.synchronize()
    assert (dk - dr).abs().max().item() <= 2e-5
    v = dr.clone()
    v[:, out_len - 5000:] = float("-inf")
    v[0, :64] = 1.0
    hk = ck.hist_uniform(v, 400)
    hr = ref.hist_uniform_ref(v, 400)
    torch.cuda.synchronize()
    assert torch.equal(hk, hr) and int(hk[0, -1]) >= 64


def test_ds_finalize_os_kernel_d1_shape_repeatable_bits(cuda):
    """ds_finalize_os (B8) at one D1 chunk's shape: two launches give
    identical bits (every sample is one thread's), both within 2e-5 of
    the twin."""
    cb, a, p, su, D0, W, _ = _os_block_args(cuda, 32768, 6000, 372000, 128,
                                            1, 8)
    assert tuple(cb.shape) == (128, 14, 32768) and W == 26752
    d1 = ck.ds_finalize_os(cb, a, p, su, D0, 1, W)
    d2 = ck.ds_finalize_os(cb, a, p, su, D0, 1, W)
    dr = ref.ds_finalize_os_ref(cb, a, p, su, D0, 1, W)
    torch.cuda.synchronize()
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32))
    assert (d1 - dr).abs().max().item() <= 2e-5


def test_os_finalize_kernels_refuse_misaligned_loads(cuda):
    """ds_finalize_os and ds_finalize_os_scan load four positions at
    once: a head that is not a multiple of 4, or stats off a 16-byte
    boundary, raise; nothing falls back to the twin."""
    cb, a, p, su, D0, W, out_len = _os_block_args(cuda, BLK, 560, 60000, 2,
                                                  1, 4)
    nv = torch.tensor([out_len], dtype=torch.int32, device=cuda)
    a_off = torch.empty(a.numel() + 1, device=cuda)[1:]
    a_off.copy_(a)
    assert a_off.is_contiguous() and a_off.data_ptr() % 16 != 0
    for head, av in ((D0 - 2, a), (D0, a_off)):
        with pytest.raises(ValueError):
            ck.ds_finalize_os(cb, av, p, su, head, 1, W)
        with pytest.raises(ValueError):
            ck.ds_finalize_os_scan(cb, av, p, su, nv, head, 1, W)


@pytest.mark.parametrize("case", ["plain-w15744", "plain-w32128", "bins",
                                  "fused-sub-pair"])
def test_chunk_routes_run_the_kernels(cuda, monkeypatch, case):
    """scan_chunks on the per-chunk route (both finalize forms, and
    non-uniform bins) and on the fused route behind the unfused prep: the
    route's kernels launch, and the outputs agree with the same scan on the
    CPU twins (hist totals exact, maxds within 2e-5, triggers exact)."""
    blk, n_c, bins = {"plain-w15744": (BLK, 560, None),
                      "plain-w32128": (32768, 560, None),
                      "bins": (BLK, 560, np.linspace(0, 1, 11) ** 2),
                      "fused-sub-pair": (BLK, 9000, None)}[case]
    if case == "plain-w15744":
        monkeypatch.setattr(tds, "FUSED_DS_BYTES", 0)
        monkeypatch.setattr(tds, "FOLD_CB_BYTES", 0)
    L_c, n = 60000, NC * n_c
    rng = np.random.default_rng(12)
    U_list = _U_list(rng, 3, 2, n)
    X = rng.standard_normal((4, NC * L_c)).astype(np.float32)
    X[1, 3 * 9000:3 * 9000 + n] += 3.0 * np.sqrt(n) * U_list[0][0]
    lens = [NC * L_c, NC * L_c, NC * (L_c - 9000), 0]
    th = np.full(3, 0.6, np.float32)
    out = {}
    for dev in ("cpu", cuda):
        bank = tds.build_bank(U_list, NC, NC * L_c, dev, block_fft=blk)
        ck.reset_launches()
        out[str(dev)] = [t.cpu() for t in tscan.scan_chunks(
            X, bank, th, NC, 250, bins=bins, max_trig=8, valid_lens=lens)]
        launched = dict(ck.LAUNCHES)
    want = {"plain-w15744": dict(rfft_ct_fused=4, irfft_ct_fused=4,
                                 ds_finalize_os_scan=4),
            "plain-w32128": dict(rfft_ct_fused=4, irfft_ct_fused=4,
                                 ds_finalize_os=4, hist_uniform=4),
            "bins": dict(rfft_ct_fused=4, irfft_ct_fused=4,
                         ds_finalize_os_scan=4),
            "fused-sub-pair": dict(rfft_ct_half=1, spec_ds_fold=1)}[case]
    assert launched == dict(_NONE, **want)
    c, g = out["cpu"], out[str(cuda)]
    assert torch.equal(c[0].sum(1), g[0].sum(1))
    assert (c[0] - g[0]).abs().sum().item() <= 40
    fin = torch.isfinite(c[1])
    assert torch.equal(fin, torch.isfinite(g[1]))
    assert (c[1][fin] - g[1][fin]).abs().max().item() <= 2e-5
    assert torch.equal(c[2], g[2]) and torch.equal(c[4], g[4])
    assert int(g[4][1, 0]) >= 1


def test_zero_gap_routes_agree_on_the_card(cuda, monkeypatch):
    """A zero-filled gap longer than the template: the fused route
    (fwd_prep_fold + spec_ds_fold) and the per-chunk route
    (ds_finalize_os_scan) both give DS exactly 0 where the float64 oracle
    has no power, and agree with it within 2e-5 elsewhere."""
    blk, n_c, L_c = GEOMS["560"]
    n = NC * n_c
    rng = np.random.default_rng(31)
    U_list = _U_list(rng, 2, 2, n)
    bank = tds.build_bank(U_list, NC, NC * L_c, cuda, block_fft=blk)
    X = rng.standard_normal((2, NC * L_c)).astype(np.float32)
    X[0, NC * 10000:NC * 12000] = 0.0
    Xt = torch.as_tensor(X, device=cuda)
    out_len = L_c - n_c + 1
    nv = np.full(2, out_len, np.int32)
    Fr, Fi, a, power = tds.os_prep_batch_fused(Xt, n_c, NC, blk)
    ur, ui = tds.bank_spec_pair(bank)
    fused, _, _ = tds.os_scan_batch_fused(
        Fr, Fi, a, power, ur, ui, bank["sum_u"], bank["d_mask"], "sub", n_c,
        NC, blk, L_c, nv)
    plain, _, _ = tds.ds_bank_demux_os_scan(
        Xt[0], out_len, bank["Ufd2"], bank["sum_u"], bank["d_mask"], n_c,
        NC, blk)
    fused = fused.reshape(2, 2, -1)[:, 0, :out_len].cpu().numpy()
    plain = plain[:, :out_len].cpu().numpy()
    for s in range(2):
        o = tds.ds_numpy(X[0], U_list[s], NC)
        gap = ~np.isfinite(o)
        assert gap.sum() == 2000 - n_c + 1
        for ds in (fused[s], plain[s]):
            assert np.all(ds[gap] == 0.0)
            assert np.abs(ds[~gap] - o[~gap]).max() <= 2e-5


def test_ds_finalize_full_kernel_matches_twin(cuda):
    """ds_finalize (B10) on the inputs ds_bank_demux gives it for one chunk
    of a full-length bank with padded rows and masked slots (S 8, Dmax 4,
    L 59,701): within 1e-5 of its twin, one launch per call; the full
    ds_bank_demux on the card against the CPU within 2e-5."""
    rng = np.random.default_rng(23)
    n = NC * 300
    U_list = _U_list(rng, 5, 3, n)
    x = rng.standard_normal(NC * 60000).astype(np.float32)
    x[NC * 7000:NC * 7000 + n] += 3.0 * np.sqrt(n) * U_list[2][0]
    out = {}
    for dev in ("cpu", cuda):
        bank = tds.build_bank(U_list, NC, x.size, dev, block_fft=0, pad_S=8,
                              min_dmax=4)
        args = (torch.as_tensor(x, device=dev), bank["Ufd2"], bank["sum_u"],
                bank["d_mask"], bank["n_c"], NC, bank["nfft2"])
        ck.reset_launches()
        out[str(dev)] = tds.ds_bank_demux(*args).cpu()
        assert ck.LAUNCHES == dict(_NONE, ds_finalize=int(dev != "cpu"))
    parts = tds.demux_parts(*args)
    assert tuple(parts[0].shape) == (8, 4, 60000 - 300 + 1)
    k = ck.ds_finalize(*parts)
    r = ref.ds_finalize_ref(*parts)
    torch.cuda.synchronize()
    assert (k - r).abs().max().item() <= 1e-5
    c, g = out["cpu"], out[str(cuda)]
    assert (c - g).abs().max().item() <= 2e-5
    assert bool((g[5:] == 0).all()) and int(g[2].argmax()) == 7000


@pytest.mark.parametrize("zerophase", [True, False])
def test_raw_path_dec2_on_the_card_matches_cpu(cuda, zerophase):
    """The device prep at dec 2 (the last bin kept after truncation is not
    a Nyquist bin and has an imaginary part, which cuFFT's C2R would not
    ignore unless zeroed): run_bank_raw and scan_chunks_raw on a
    full-length bank, and scan_chunks_raw on an overlap-save bank, on the
    card against the same calls on the CPU; a ragged chunk among them."""
    dec, n_c, L_raw = 2, 500, 80000
    n = NC * n_c
    rng = np.random.default_rng(29 + zerophase)
    U_list = _U_list(rng, 3, 2, n)
    X = rng.standard_normal((2, NC, L_raw)).astype(np.float32)
    X += np.linspace(0, 4, L_raw, dtype=np.float32)
    lens = [L_raw, L_raw - 9000]
    X[1, :, lens[1]:] = 0.0
    Lc = L_raw // dec * NC
    filt = [1.0, 10.0, 2, zerophase]
    out = {}
    for dev in ("cpu", cuda):
        full = tds.build_bank(U_list, NC, Lc, dev, block_fft=0)
        osb = tds.build_bank(U_list, NC, Lc, dev, block_fft=16384)
        H = tprep.butter_response(filt, 100.0, dec * full["nfft2"],
                                  zerophase, device=dev)
        ck.reset_launches()
        res = [tprep.run_bank_raw(X[1, :, :lens[1]], full, NC, H, dec)]
        for bank in (full, osb):
            res += [t.cpu() for t in tscan.scan_chunks_raw(
                X, lens, H, bank, np.full(3, 0.6, np.float32), NC, 250,
                max_trig=4, dec=dec)]
        out[str(dev)] = res
        if dev != "cpu":
            assert ck.LAUNCHES["ds_finalize"] == 3
    c, g = out["cpu"], out[str(cuda)]
    assert np.abs(c[0] - g[0]).max() <= 2e-5
    for i in (1, 6):                     # hist, maxds, idx, val, count
        assert torch.equal(c[i].sum(1), g[i].sum(1))
        assert (c[i] - g[i]).abs().sum().item() <= 40
        assert (c[i + 1] - g[i + 1]).abs().max().item() <= 2e-5
        assert torch.equal(c[i + 2], g[i + 2])
        assert torch.equal(c[i + 4], g[i + 4])


# (blk, rows R, frames m, stride W; None: contiguous rows [R, blk]): one
# transform, row counts that no number of resident rows divides, more rows
# than one wave of the card holds, and overlapping frames read in place
# from rows longer than the frames need
FRAME_CASES = [(16384, 1, 1, None), (32768, 1, 1, None),
               (16384, 5, 1, None), (32768, 3, 1, None),
               (16384, 301, 1, None), (16384, 6, 55, 13312),
               (16384, 3, 98, 7296), (32768, 3, 14, 26752),
               (16384, 2, 3, 128)]


def _frame_source(cuda, blk, R, m, W, seed):
    Lp = blk if W is None else (m - 1) * W + blk + 256
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (R, Lp)).astype(np.float32), device=cuda)
    rows = x if W is None else x.unfold(1, blk, W)[:, :m].reshape(-1, blk)
    return x, rows


@pytest.mark.parametrize("blk,R,m,W", FRAME_CASES)
def test_rfft_ct_kernel_frames_match_twin(cuda, blk, R, m, W):
    """rfft_ct_fused (B4) on contiguous rows and on frames read in place,
    against unfold + the twin; one launch either way."""
    x, rows = _frame_source(cuda, blk, R, m, W, blk + R)
    ck.reset_launches()
    k = ck.rfft_ct_fused(x, blk, stride=W, frames=m)
    assert ck.LAUNCHES == dict(_NONE, rfft_ct_fused=1)
    r = ref.rfft_ct_fused_ref(rows, blk)
    torch.cuda.synchronize()
    assert k.shape == r.shape
    assert (k - r).abs().max().item() <= 2e-3


@pytest.mark.parametrize("blk,R,m,W", FRAME_CASES)
def test_rfft_ct_half_kernel_frames_match_twin(cuda, blk, R, m, W):
    """rfft_ct_half (B6) on contiguous rows and on frames read in place,
    against unfold + the twin; zeros past blk/2 exact."""
    x, rows = _frame_source(cuda, blk, R, m, W, blk + R + 1)
    ck.reset_launches()
    k = ck.rfft_ct_half(x, blk, stride=W, frames=m)
    assert ck.LAUNCHES == dict(_NONE, rfft_ct_half=1)
    r = ref.rfft_ct_half_ref(rows, blk)
    torch.cuda.synchronize()
    Rb = blk // 2 + 1
    for a, b in zip(k, r):
        assert a.shape == b.shape
        assert (a[:, :Rb] - b[:, :Rb]).abs().max().item() <= 2e-3
        assert bool((a[:, Rb:] == 0).all())


def test_forward_transforms_refuse_misaligned_frames(cuda):
    """A stride or row length that is not a multiple of 4 samples (frames
    off the 16-byte boundary the kernels load by) raises; nothing falls
    back to another transform."""
    x = torch.zeros((2, 16384 + 4 * 130), device=cuda)
    for fn in (ck.rfft_ct_fused, ck.rfft_ct_half):
        with pytest.raises(ValueError):
            fn(x, 16384, stride=130, frames=3)
        with pytest.raises(ValueError):
            fn(x[:, :-2], 16384, stride=128, frames=3)
        with pytest.raises(ValueError):
            fn(x, 16384, stride=128, frames=6)


@pytest.mark.parametrize("path", ["os_prep_batch", "os_prep",
                                  "os_prep_batch_pair"])
def test_prep_paths_read_frames_in_place(cuda, monkeypatch, path):
    """The three call paths of the forward transforms hand the kernel the
    padded demuxed batch itself (its storage, its rows, the frame stride
    and count), so no copy of the overlapping frames is made; one launch a
    call; the result equals the twin's on the copied frames."""
    blk, n_c, L_c = (BLK, 9000, 60000) if path.endswith("pair") else (
        BLK, 560, 60000)
    rng = np.random.default_rng(41)
    X = torch.as_tensor(rng.standard_normal((2, NC * L_c)).astype(
        np.float32), device=cuda)
    _, _, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    seen = {}
    demux = tds.standardize_demux
    name = "rfft_ct_half" if path.endswith("pair") else "rfft_ct_fused"
    kernel = getattr(ck, name)

    def spy_demux(*args):
        seen["xq"] = demux(*args)[0]
        return seen["xq"], None

    def spy_kernel(x, n, stride=None, frames=1):
        seen["call"] = (x.data_ptr(), tuple(x.shape), n, stride, frames)
        return kernel(x, n, stride=stride, frames=frames)

    monkeypatch.setattr(tds, "standardize_demux", spy_demux)
    monkeypatch.setattr(ck, name, spy_kernel)
    ck.reset_launches()
    if path == "os_prep":
        out = tds.os_prep(X[0], n_c, NC, blk)[0][None]
    else:
        out = getattr(tds, path)(X, n_c, NC, blk)[:2 if path.endswith(
            "pair") else 1]
        out = out[0] if len(out) == 1 else out
    assert ck.LAUNCHES == dict(_NONE, **{name: 1})
    xq = seen["xq"]
    B = xq.shape[0]
    assert seen["call"] == (xq.data_ptr(), (B * NC, m * W + D0), blk, W, m)
    frames = xq.unfold(2, blk, W).reshape(-1, blk)
    Rb = blk // 2 + 1
    if path.endswith("pair"):
        want = ref.rfft_ct_half_ref(frames, blk)
        Rp = dft.half_rp(blk)
        for a, b in zip(out, want):
            a = a.reshape(-1, Rp)
            assert (a[:, :Rb] - b[:, :Rb]).abs().max().item() <= 2e-3
            assert bool((a[:, Rb:] == 0).all())
    else:
        want = ref.rfft_ct_fused_ref(frames, blk).reshape(B, NC, m, Rb)
        assert (out - want).abs().max().item() <= 2e-3


def test_blocked_route_equals_per_block_scans_on_the_card(cuda):
    """The template-blocked batch route on the card (300 single templates
    padded to pad_rows(300) = 320 rows, three blocks; the last holds 64
    pad rows): one fwd_prep_fold and one spec_ds_fold a block, and
    histograms, maxima and triggers equal, bit for bit, to the same bank
    scanned as three banks of 128 (slices of its arrays) through the
    unblocked route."""
    rng = np.random.default_rng(300)
    S, L_c, B, n = 300, 40000, 3, NC * 560
    U_list = _U_list(rng, S, 1, n)
    X = rng.standard_normal((B, NC * L_c)).astype(np.float32)
    for b, s in ((0, 5), (2, 299)):
        X[b, NC * 9000:NC * 9000 + n] += 150.0 * U_list[s][0]
    bank = tds.build_bank(U_list, NC, NC * L_c, cuda, pad_S=tds.pad_rows(S))
    Sp = int(bank["sum_u"].shape[0])
    th = np.full(Sp, 0.5, np.float32)
    th[S:] = np.inf
    ck.reset_launches()
    tscan.ROUTE_COUNTS.clear()
    got = tscan.scan_chunks(X, bank, th, NC, 250, max_trig=4)
    torch.cuda.synchronize()
    assert dict(tscan.ROUTE_COUNTS) == {"blocked-fused-net+fusedprep": 1}
    assert dict(ck.LAUNCHES) == dict(_NONE, fwd_prep_fold=1, spec_ds_fold=3)
    parts = []
    for i in range(0, Sp, 128):
        sub = {k: v for k, v in bank.items() if not k.startswith("_")}
        for k in ("Ufd2", "sum_u", "d_mask"):
            sub[k] = bank[k][i:i + 128]
        parts.append(tscan.scan_chunks(X, sub, th[i:i + 128], NC, 250,
                                       max_trig=4))
    assert torch.equal(got[0], torch.cat([p[0] for p in parts]))
    for k in range(1, 5):
        torch.testing.assert_close(
            got[k], torch.cat([p[k] for p in parts], dim=1), rtol=0, atol=0,
            equal_nan=True)
    assert got[0].shape == (Sp, 400) and int(got[4].sum()) == 2
    assert int(got[4][0, 5]) == 1 and int(got[4][2, 299]) == 1


def _engine_station(rng, n_det, D, n, chunks, L_c, events, sr):
    """A station of ``n_det`` subspace detectors and a chunks(sta) callable
    over ``chunks`` noise chunks of L_c samples a channel, with planted
    events {chunk: (detector, channel sample)}."""
    from detex_torch.core import Stream, Trace
    Us = [_U_list(rng, 1, D, n)[0] for _ in range(n_det)]
    dets = [dict(name="d%d" % i, U=U, WFs=3.0 * U[:2], mags=[1.0, 1.4],
                 events=["e0", "e1"], offsets=[0.0, 0.4], threshold=0.4)
            for i, U in enumerate(Us)]
    data = rng.standard_normal((chunks, NC, L_c))
    for b, (s, at) in events.items():
        data[b, :, at:at + n // NC] += 150.0 * Us[s][0].reshape(-1, NC).T

    def gen(sta):
        for b in range(chunks):
            yield Stream([Trace(data[b, c].copy(), dict(
                network="XX", station="S1", channel="BH" + "ENZ"[c],
                sampling_rate=sr, starttime=1.0e9 + b * L_c / sr))
                for c in range(NC)]), None, None
    return {"XX.S1": dict(channels=["BHE", "BHN", "BHZ"], sr=sr,
                          detectors=dets)}, gen


def test_engine_on_the_card_matches_cpu(cuda, tmp_path):
    """detect.detex on the card against the same engine on the CPU: the
    same rows in the same order (STMP and Name exact, DS within 2e-5,
    magnitudes within 1e-5), histogram totals exact, and the summary scan
    and the dense re-verify launched their kernels."""
    from detex_torch import detect, util
    rng = np.random.default_rng(77)
    L_c, sr = 24000, 25.0
    stations, gen = _engine_station(
        rng, 3, 3, NC * 560, 5, L_c, {1: (0, 7000), 3: (2, 15000),
                                      4: (1, 100)}, sr)
    rows, hists = {}, {}
    for dev in ("cpu", cuda):
        db = str(tmp_path / ("%s.db" % str(dev)))
        ck.reset_launches()
        hists[str(dev)] = detect.detex(
            stations, gen, db, conDatDuration=L_c / sr, conBuff=0.0,
            batchSize=4, device=dev)
        rows[str(dev)] = util.loadSQLite(db, "ss_df", columns=True)
    launched = dict(ck.LAUNCHES)
    for k in ("fwd_prep_fold", "spec_ds_fold", "rfft_ct_fused",
              "irfft_ct_fused", "ds_finalize_os_fold"):
        assert launched[k] > 0, k
    c, g = rows["cpu"], rows[str(cuda)]
    assert len(c["STMP"]) == 3
    assert list(g["Name"]) == list(c["Name"])
    np.testing.assert_array_equal(g["STMP"], c["STMP"])
    np.testing.assert_allclose(g["DS"], c["DS"], rtol=0, atol=2e-5)
    for col in ("Mag", "SNR", "ProEnMag"):
        np.testing.assert_allclose(g[col], c[col], rtol=0, atol=1e-5)
    for name, h in hists["cpu"]["XX.S1"].items():
        assert hists[str(cuda)]["XX.S1"][name].sum() == h.sum()


def test_engine_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    """With no card the engine asked for "cuda" raises through
    detex_torch.require_cuda, before it reads a chunk."""
    from detex_torch import detect

    def no_chunks(sta):
        raise AssertionError("chunks read")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stations = {"XX.S1": dict(channels=["BHZ"], sr=25.0, detectors=[
        dict(name="d0", U=np.ones((1, 100)) / 10.0, WFs=np.ones((1, 100)),
             mags=[1.0], events=["e0"], offsets=[0.0], threshold=0.5)])}
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        detect.detex(stations, no_chunks, str(tmp_path / "x.db"))


@pytest.mark.parametrize("n", [3 * 13000, 3001])
def test_xcorr_and_svd_on_the_card_match_cpu(cuda, n):
    """ops/xcorr.xcorr_all_pairs on the polyphase (n % 3 == 0) and the
    full path, and svd_basis / frac_energy at dtype "single", on the card
    against device="cpu": cc within 1e-5, subsample within 1e-4, lags
    exact for pairs whose cc passes 0.5 (a clear peak; a pair whose
    aligned window overruns the zero padding may pass 1 and be zeroed, as
    the reference does, so not every family pair counts); on waveforms
    with well-separated singular values the projectors onto the leading
    1..6 singular vectors, the singular values and the energy capture
    within 1e-5."""
    from detex_torch.ops import svd, xcorr
    rng = np.random.default_rng(n)
    N, L = 24, -(-n // NC)
    X = rng.standard_normal((N, L * NC))
    for f in range(4):
        sig = 6.0 * np.hanning(L // 4) * rng.standard_normal(L // 4)
        for e in range(f, N, 6):
            at = rng.integers(0, L - len(sig))
            w = np.zeros((NC, L))
            w[:, at:at + len(sig)] = sig
            X[e] += w.flatten(order="F")
    X = X[:, :n].astype(np.float32)
    got = xcorr.xcorr_all_pairs(X, NC, pair_batch=100, device=cuda)
    want = xcorr.xcorr_all_pairs(X, NC, device="cpu")
    iu = np.triu_indices(N, 1)
    assert np.abs(got[0][iu] - want[0][iu]).max() <= 1e-5
    assert np.abs(got[2][iu] - want[2][iu]).max() <= 1e-4
    fam = want[0][iu] > 0.5
    assert fam.sum() >= 12
    np.testing.assert_array_equal(got[1][iu][fam], want[1][iu][fam])
    # six waveforms with well-separated singular values (5 ... 0.5), so
    # every leading subspace is determined to float32 rounding
    q, _ = np.linalg.qr(rng.standard_normal((1200, 6)))
    mix, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    A = (mix * [5.0, 4.0, 3.0, 2.0, 1.0, 0.5]) @ q.T * 40.0
    A0 = A - A.mean(axis=1, keepdims=True)
    Ug, sg = svd.svd_basis(A0, dtype="single", device=cuda)
    Uc, sc = svd.svd_basis(A0, dtype="single", device="cpu")
    for d in range(1, 7):
        np.testing.assert_allclose(Ug[:, :d] @ Ug[:, :d].T,
                                   Uc[:, :d] @ Uc[:, :d].T, rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(sg, sc, rtol=1e-5)
    np.testing.assert_allclose(
        svd.frac_energy(Ug, A, dtype="single", device=cuda),
        svd.frac_energy(Uc, A, dtype="single", device="cpu"), rtol=0,
        atol=1e-5)


def test_case1_key_file_pipeline_on_the_card_matches_record(cuda, tmp_path):
    """Phase H1 at dtype "double" on the card: the port's SynthCatalog
    directories through createCluster(fetch_arg=...) ... detResults,
    held by chip_smoke.case1_hold against detex_tpu's record
    (tests/data/case1_reference.json): clusters, delays and NumBasis
    identical, lags identical or near ties of the float64 oracle,
    thresholds within 1e-5 relative, every row's STMP exact and DS within
    2e-5, both hidden events verified inside their windows."""
    import json
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke as cs
    with open(cs.CASE1_FIXTURE) as fh:
        fixture = json.load(fh)
    rec, objs, _ = cs.case1_run(fixture["params"], "double", str(tmp_path),
                                cuda)
    _, ds_err, _ = cs.case1_hold("card double", rec, fixture["double"],
                                 objs)
    assert ds_err <= 2e-5
