"""The sharded scans on the card: across every CUDA device of the host (or
cuda:0 twice over on a one-card host) against the unsharded scan of the
same batch, and the scan kernels on the last card against their twins.
Marked ``cuda``: every test skips without a CUDA device. This file
imports neither jax nor detex_tpu:

    python -m pytest tests/test_torch_mesh_cuda.py -m cuda --noconftest -q

Tolerances: histograms, trigger counts and indices exact; maxima and
trigger values bit for bit where the per-shard route is the whole
batch's, within 1e-6 otherwise; the kernels on the last card as
tests/test_torch_cuda.py holds them (spectra 2e-3, DS 2e-5).
"""
import numpy as np
import pytest
import torch

import detex_torch
from detex_torch.ops import cuda_kernels as ck
from detex_torch.ops import ds as tds
from detex_torch.ops import reference as ref
from detex_torch.parallel import mesh as tmesh
from detex_torch.parallel import scan as tscan

pytestmark = pytest.mark.cuda

NC = 3
N = 1680
LC = 3 * 35000


@pytest.fixture()
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    detex_torch.require_cuda()
    n = torch.cuda.device_count()
    return (tmesh.make_mesh() if n > 1
            else tmesh.make_mesh(devices=["cuda:0"] * 2))


def _bank(rng, S, D, device, prefer_os=True):
    Us = []
    for _ in range(S):
        q, _ = np.linalg.qr(rng.standard_normal((N, D)))
        Us.append(np.ascontiguousarray(q.T))
    return tds.build_bank(Us, NC, LC, device, prefer_os=prefer_os), Us


def _np(out):
    return [t.cpu().numpy() for t in out]


@pytest.mark.parametrize("case", ["fused", "blocked", "plain-full",
                                  "raw-demux"])
def test_sharded_scan_matches_unsharded(mesh, case):
    """An odd batch (7 chunks, padded to the mesh) with triggers on, on
    the fused route (3 templates), the blocked route (129), the
    full-length "plain" route and the raw "raw-demux" route."""
    rng = np.random.default_rng(len(case))
    S = 129 if case == "blocked" else 3
    bank, Us = _bank(rng, S, 2, "cuda", prefer_os=not case.endswith(
        ("full", "demux")))
    X = rng.standard_normal((7, LC)).astype(np.float32)
    X[4, 3 * 5000:3 * 5000 + N] += 60.0 * Us[S - 1][0]
    th = np.full(S, 0.4, np.float32)
    if case == "raw-demux":
        Xc = np.ascontiguousarray(X.reshape(7, LC // NC, NC).transpose(
            0, 2, 1))
        H = torch.ones(bank["nfft2"] // 2 + 1, device="cuda")

        def run(m):
            return tscan.scan_chunks_raw(Xc, [LC // NC] * 7, H, bank, th,
                                         NC, 250, max_trig=8, mesh=m)
    else:
        def run(m):
            return tscan.scan_chunks(X, bank, th, NC, 250, max_trig=8,
                                     mesh=m)
    tscan.ROUTE_COUNTS.clear()
    h_s, m_s, i_s, v_s, c_s = _np(run(mesh))
    (route_s,) = tscan.ROUTE_COUNTS
    tscan.ROUTE_COUNTS.clear()
    h_1, m_1, i_1, v_1, c_1 = _np(run(None))
    (route_1,) = tscan.ROUTE_COUNTS
    assert "+sharded" in route_s and "+sharded" not in route_1
    assert np.array_equal(h_s, h_1)
    assert np.array_equal(c_s, c_1) and np.array_equal(i_s, i_1)
    assert int(c_s[4, S - 1]) >= 1
    k = i_1 >= 0
    if route_s.replace("+sharded", "") == route_1:
        assert np.array_equal(m_s, m_1)
        assert np.array_equal(v_s[k], v_1[k])
    else:
        fin = np.isfinite(m_1)
        assert np.abs(m_s[fin] - m_1[fin]).max() <= 1e-6


def test_scan_kernels_on_the_last_card(mesh):
    """fwd_prep_fold and spec_ds_fold on the last card of the host against
    their twins (the cards past cuda:0 take their shards)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(5)
    bank, _ = _bank(rng, 8, 3, dev)
    blk, n_c = bank["blk_fft"], N // NC
    L_c = LC // NC
    out_len, pad0, D0, W, m = tds._os_geometry(L_c, n_c, blk)
    xq = torch.zeros((4, NC, m * W + D0), dtype=torch.float32, device=dev)
    xq[:, :, pad0:pad0 + L_c] = torch.as_tensor(
        rng.standard_normal((4, NC, L_c)).astype(np.float32), device=dev)
    before = dict(ck.LAUNCHES)
    k = ck.fwd_prep_fold(xq, NC, n_c, blk, out_len)
    r = ref.fwd_prep_fold_ref(xq, NC, n_c, blk, out_len)
    R = blk // 2 + 1
    Rp = k[0].shape[1] // m
    for a, b in zip(k[:2], r[:2]):
        d = (a.reshape(-1, m, Rp)[..., :R] - b.reshape(-1, m, Rp)[..., :R])
        assert d.abs().max().item() <= 2e-3
    nv = torch.full((4,), out_len, dtype=torch.int32, device=dev)
    ur, ui = tds.bank_spec_pair(bank)
    args = (ur, ui) + tuple(r) + (bank["sum_u"].T.contiguous(), nv, "net",
                                  NC, W, D0, blk)
    _, pk, _ = ck.spec_ds_fold(*args, emit_ds=False)
    _, pr, _ = ref.spec_ds_fold_ref(*args, emit_ds=False)
    assert pk.device == dev
    fin = torch.isfinite(pr)
    assert torch.equal(torch.isfinite(pk), fin)
    assert (pk[fin] - pr[fin]).abs().max().item() <= 2e-5
    assert ck.LAUNCHES["fwd_prep_fold"] == before["fwd_prep_fold"] + 1
    assert ck.LAUNCHES["spec_ds_fold"] == before["spec_ds_fold"] + 1
