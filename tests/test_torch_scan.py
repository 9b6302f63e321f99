"""detex_torch's fused overlap-save scan held against detex_tpu on the CPU.

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra. detex_tpu runs its fused
Pallas kernels in interpret mode (DETEX_TPU_PALLAS=1,
DETEX_TPU_MATMUL_FFT=1, as tests/test_spec_ds.py does); the port runs the
kernels' plain PyTorch twins, which is what its wrappers do with CPU
tensors. Tolerances are those of tests/test_fwd_prep.py and
tests/test_spec_ds.py: spectra atol 2e-3, a atol 1e-4, power rtol 1e-4 /
atol 1e-3, DS and maxima atol 2e-5, histogram totals exact with at most 40
edge-ULP bin moves, trigger indices and counts exact.
"""
import json

import numpy as np
import pytest
import torch

from detex_tpu import serving as jserving
from detex_tpu.ops import dft as jdft
from detex_tpu.ops import ds as jds
from detex_tpu.ops import triggers as jtrig
from detex_tpu.parallel import scan as jscan
from detex_torch import serving as tserving
from detex_torch.ops import ds as tds
from detex_torch.ops import triggers as ttrig
from detex_torch.parallel import scan as tscan

NC = 3
N = 1680
LC = 3 * 35000
BLK = 16384


@pytest.fixture()
def jax_fused_env(monkeypatch):
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    monkeypatch.setenv("DETEX_TPU_MATMUL_FFT", "1")
    yield


def _U_list(rng, S, D, n=N):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def _banks(U_list, Lc=LC, block_fft=BLK):
    jb = jds.build_bank(U_list, NC, Lc, prefer_os=True, block_fft=block_fft)
    tb = tds.bank_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                  else v) for k, v in jb.items()}, "cpu")
    return jb, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_hist(h_t, h_j, max_moves=40):
    h_t = _np(h_t).astype(np.int64)
    h_j = _np(h_j).astype(np.int64)
    assert np.array_equal(h_t.sum(axis=-1), h_j.sum(axis=-1))
    assert np.abs(h_t - h_j).sum() <= max_moves


@pytest.mark.parametrize("n_c", [560, 129])
def test_prep_matches_jax(jax_fused_env, n_c):
    """os_prep_batch_fused: spectra (bins <= blk/2), window stats and the
    pad convention (a = 0, power = 1 past out_len) against detex_tpu's
    fused prep; n_c = 129 is the pad0 == 0 branch."""
    rng = np.random.default_rng(3 + n_c)
    X = rng.standard_normal((2, LC)).astype(np.float32)
    out_len, pad0, D0, W, m = tds._os_geometry(LC // NC, n_c, BLK)
    assert tds.fwd_prep_ok(n_c, NC, BLK) and jds.fwd_prep_ok(n_c, NC, BLK)
    Fr_t, Fi_t, a_t, p_t = map(_np, tds.os_prep_batch_fused(
        torch.from_numpy(X), n_c, NC, BLK))
    Fr_j, Fi_j, a_j, p_j = map(np.asarray, jds.os_prep_batch_fused(
        X, n_c, NC, BLK))
    Rp = jdft.half_rp(BLK)
    R = BLK // 2 + 1
    assert Fr_t.shape == (2 * NC, m * Rp) and a_t.shape == (2, m * W)

    def bins(F):
        return F[:, :m * Rp].reshape(2 * NC, m, Rp)[..., :R]
    # float64 oracle of the same standardized, framed chunks: the port
    # must sit within 2e-3 of it everywhere, and within 2e-3 of detex_tpu
    # wherever detex_tpu itself is exact (its interpret-mode bf16x3 dots
    # deviate from float64 by up to ~2.3e-3 at this frame size)
    X64 = X.astype(np.float64)
    xs = (X64 - X64.mean(1, keepdims=True)) / X64.std(1, keepdims=True)
    xq = np.zeros((2, NC, m * W + D0))
    xq[:, :, pad0:pad0 + LC // NC] = xs.reshape(2, -1, NC).transpose(0, 2, 1)
    F64 = np.stack([np.fft.rfft(xq[..., f * W:f * W + BLK], axis=-1)
                    for f in range(m)], axis=2).reshape(2 * NC, m, R)
    for t, j, o in ((Fr_t, Fr_j, F64.real), (Fi_t, Fi_j, F64.imag)):
        assert np.abs(bins(t) - o).max() <= 2e-3
        assert np.all(np.abs(bins(t) - bins(j)) <= 2e-3 + np.abs(bins(j) - o))
    assert np.all(Fr_t.reshape(2 * NC, m, Rp)[..., R:] == 0)
    np.testing.assert_allclose(a_t[:, :out_len], a_j[:, :out_len], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(p_t[:, :out_len], p_j[:, :out_len],
                               rtol=1e-4, atol=1e-3)
    assert np.all(a_t[:, out_len:] == 0.0)
    assert np.all(p_t[:, out_len:] == 1.0)


@pytest.mark.parametrize("mode,S,B,emit_ds", [
    ("sub", 3, 8, True), ("sub", 3, 8, False),
    ("net", 8, 4, True), ("net", 8, 4, False)])
def test_os_scan_batch_fused_matches_jax(jax_fused_env, mode, S, B, emit_ds):
    """One spec -> DS pass on identical prep arrays (detex_tpu's fused prep
    output fed to both): ds, block maxima and histograms."""
    rng = np.random.default_rng(20 + S)
    U_list = _U_list(rng, S=S, D=3)
    jb, tb = _banks(U_list)
    X = rng.standard_normal((B, LC)).astype(np.float32)
    X[1, 6000:6000 + N] += 150.0 * U_list[0][0]
    n_c = jb["n_c"]
    L_c = LC // NC
    nv = np.full(B, L_c - n_c + 1, np.int32)
    nv[2] -= 20000                                   # ragged chunk
    assert jds.spec_ds_mode(B, S, jb["Dmax"], n_c, NC, BLK) == mode
    assert tds.spec_ds_mode(B, S, tb["Dmax"], n_c, NC, BLK) == mode
    prep = [np.asarray(v) for v in jds.os_prep_batch_fused(X, n_c, NC, BLK)]
    jur, jui = jds.bank_spec_pair(jb, "f32")
    ds_j, pyr_j, h_j = jds.os_scan_batch_fused(
        *prep, jur, jui, jb["sum_u"], jb["d_mask"], mode, n_c, NC, BLK, L_c,
        nv, nbin=400, emit_ds=emit_ds)
    tur, tui = tds.bank_spec_pair(tb)
    ds_t, pyr_t, h_t = tds.os_scan_batch_fused(
        *[torch.tensor(v) for v in prep], tur, tui, tb["sum_u"],
        tb["d_mask"], mode, n_c, NC, BLK, L_c, nv, nbin=400,
        emit_ds=emit_ds)
    pyr_j, pyr_t = np.asarray(pyr_j), _np(pyr_t)
    assert pyr_t.shape == pyr_j.shape
    assert np.array_equal(np.isfinite(pyr_t), np.isfinite(pyr_j))
    fin = np.isfinite(pyr_j)
    np.testing.assert_allclose(pyr_t[fin], pyr_j[fin], rtol=0, atol=2e-5)
    _check_hist(h_t, h_j)
    if emit_ds:
        ds_j, ds_t = np.asarray(ds_j), _np(ds_t)
        assert np.array_equal(np.isfinite(ds_t), np.isfinite(ds_j))
        fin = np.isfinite(ds_j)
        np.testing.assert_allclose(ds_t[fin], ds_j[fin], rtol=0, atol=2e-5)
    else:
        assert ds_t is None and ds_j is None


def _check_scan(out_t, out_j, calc_triggers):
    h_t, m_t, ti_t, tv_t, tc_t = map(_np, out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    _check_hist(h_t, h_j)
    np.testing.assert_allclose(m_t, m_j, rtol=0, atol=2e-5)
    assert ti_t.shape == ti_j.shape and tc_t.shape == tc_j.shape
    assert np.array_equal(ti_t, ti_j)
    assert np.array_equal(tc_t, tc_j)
    if calc_triggers:
        k = ti_j >= 0
        np.testing.assert_allclose(tv_t[k], tv_j[k], rtol=0, atol=2e-5)
        assert np.all(np.isnan(tv_t[~k]))


@pytest.mark.parametrize("mode,S,B", [("sub", 3, 8), ("net", 8, 4)])
@pytest.mark.parametrize("calc_triggers", [True, False])
def test_scan_chunks_matches_jax(jax_fused_env, mode, S, B, calc_triggers):
    """scan_chunks end to end (route fused-<mode>+fusedprep in both
    packages) with a planted event and a ragged valid length; the planted
    maxds also agrees with the float64 oracle."""
    rng = np.random.default_rng(40 + S + int(calc_triggers))
    U_list = _U_list(rng, S=S, D=4)
    jb, tb = _banks(U_list)
    X = rng.standard_normal((B, LC)).astype(np.float32)
    X[1, 5001:5001 + N] += 150.0 * U_list[0][0]
    X[2, 9000:9000 + N] += 150.0 * U_list[S - 1][0]
    lens = [LC] * B
    lens[3] = LC - 3000
    X[3, lens[3]:] = 0.0
    th = np.full(S, 0.6, np.float32)
    kw = dict(buff_samps=250, max_trig=8, valid_lens=lens,
              calc_triggers=calc_triggers)
    jscan.ROUTE_COUNTS.clear()
    tscan.ROUTE_COUNTS.clear()
    out_j = jscan.scan_chunks(X, dict(jb), th, NC, **kw)
    out_t = tscan.scan_chunks(X, tb, th, NC, **kw)
    route = "fused-%s+fusedprep" % mode
    assert dict(jscan.ROUTE_COUNTS) == {route: 1}
    assert dict(tscan.ROUTE_COUNTS) == {route: 1}
    _check_scan(out_t, out_j, calc_triggers)
    maxds = _np(out_t[1])
    ds64 = tds.ds_numpy(X[1].astype(np.float64), U_list[0], NC)
    assert abs(np.nanmax(ds64) - maxds[1, 0]) < 2e-5
    if calc_triggers:
        tidx, tcnt = _np(out_t[2]), _np(out_t[4])
        assert tcnt[1, 0] >= 1 and tidx[1, 0, 0] == np.nanargmax(ds64)
        assert tcnt[2, S - 1] >= 1
    else:
        assert _np(out_t[2]).shape == (B, S, 0)


def test_triggers_match_jax():
    """Batched pyramid trigger extraction equals detex_tpu's per-row scan:
    exact indices and counts, ties to the first occurrence, three-case
    clamp at both row ends, fully masked rows."""
    rng = np.random.default_rng(11)
    R, nblk, block = 6, 24, 128
    L = nblk * block
    v = (rng.random((R, L)) * 0.3).astype(np.float32)
    v[0, [5, 700, 701, 2000, L - 3]] = [0.9, 0.8, 0.8, 0.95, 0.85]
    v[1, 100:400] = 0.7                      # a plateau: ties everywhere
    v[2, :] = -np.inf                        # empty padded chunk
    v[3, L - 500:] = -np.inf                 # ragged tail
    v[3, L - 600] = 0.99
    v[4, rng.integers(0, L, 40)] = 0.75      # more peaks than capacity
    pyr = v.reshape(R, nblk, block).max(axis=-1)
    th = np.array([0.6, 0.6, 0.6, 0.5, 0.6, 0.25], np.float32)
    idx_t, cnt_t = ttrig.extract_triggers_pyramid_pm(
        torch.from_numpy(v), torch.from_numpy(pyr), torch.from_numpy(th),
        250, max_triggers=8)
    for r in range(R):
        idx_j, cnt_j = jtrig.extract_triggers_pyramid_pm(
            v[r], pyr[r], th[r], 250, max_triggers=8)
        assert np.array_equal(_np(idx_t[r]), np.asarray(idx_j)), r
        assert int(cnt_t[r]) == int(cnt_j), r


def test_serving_matches_jax(jax_fused_env, tmp_path):
    """load_detectors + scan_station on one hand-written artifact in
    export_detectors' schema against detex_tpu.serving."""
    rng = np.random.default_rng(12)
    sr, S, B = 25.0, 8, 2
    U_list = _U_list(rng, S=S, D=1)
    meta = {"stations": {"XX.S01": {"nc": NC, "sr": sr, "detectors": [
        dict(name="SG%d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%d" % s]) for s in range(S)]}},
        "filt": [1, 8, 2, True], "decimate": 1, "version": 1}
    arrays = {"U__XX.S01__SG%d" % s: U_list[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = str(tmp_path / "detectors.npz")
    np.savez(path, **arrays)
    dep_j = jserving.load_detectors(path, chunk_sec=1200, conBuff=100)
    dep_t = tserving.load_detectors(path, chunk_sec=1200, conBuff=100,
                                    device="cpu")
    bj, bt = dep_j["XX.S01"]["banks"][0], dep_t["XX.S01"]["banks"][0]
    assert bj["blk_fft"] == bt["blk_fft"] == BLK
    assert bj["pad_len"] == bt["pad_len"] and bt["names"] == bj["names"]
    Lc = int(1300 * sr * NC)
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    X[1, 30000:30000 + N] += 150.0 * U_list[2][0]
    # identical template spectra on both sides
    bt.update(tds.bank_from_numpy({k: np.asarray(bj[k]) for k in
                                   ("Ufd2", "sum_u", "d_mask")}
                                  | dict(os=True), "cpu"))
    res_j = jserving.scan_station(dep_j, "XX.S01", X, max_trig=8)
    res_t = tserving.scan_station(dep_t, "XX.S01", X, max_trig=8)
    for rj, rt in zip(res_j, res_t):
        _check_scan([rt[k] for k in ("hist", "maxds", "trig_idx",
                                     "trig_val", "trig_count")],
                    [rj[k] for k in ("hist", "maxds", "trig_idx",
                                     "trig_val", "trig_count")], True)
        assert rt["trig_count"][1, 2] >= 1


def test_zero_gap_fused_and_plain_routes_agree_with_oracle(monkeypatch):
    """A chunk with a zero-filled gap longer than the template: the fused
    route (fwd_prep_fold's exact zero-power rule) and the per-chunk
    "plain" route (rolling.window_stats_rows) give DS exactly 0 at every
    window the float64 oracle finds without power (the gap), and agree
    with the oracle within 2e-5 elsewhere; their scans agree too."""
    rng = np.random.default_rng(31)
    U_list = _U_list(rng, S=2, D=2)
    tb = tds.build_bank(U_list, NC, LC, "cpu", block_fft=BLK)
    B = 2
    X = rng.standard_normal((B, LC)).astype(np.float32)
    X[0, NC * 10000:NC * 12000] = 0.0                     # the gap
    X[0, NC * 20000:NC * 20000 + N] += 150.0 * U_list[1][0]
    n_c, L_c = N // NC, LC // NC
    out_len = L_c - n_c + 1
    nv = np.full(B, out_len, np.int32)
    Xt = torch.from_numpy(X)
    Fr, Fi, a, power = tds.os_prep_batch_fused(Xt, n_c, NC, BLK)
    ur, ui = tds.bank_spec_pair(tb)
    fused, _, _ = tds.os_scan_batch_fused(
        Fr, Fi, a, power, ur, ui, tb["sum_u"], tb["d_mask"], "sub", n_c, NC,
        BLK, L_c, nv)
    fused = fused.reshape(2, B, -1)[:, 0, :out_len].numpy()
    plain, _, _ = tds.ds_bank_demux_os_scan(
        Xt[0], out_len, tb["Ufd2"], tb["sum_u"], tb["d_mask"], n_c, NC, BLK)
    plain = plain[:, :out_len].numpy()
    for s in range(2):
        o = tds.ds_numpy(X[0], U_list[s], NC)
        gap = ~np.isfinite(o)
        assert gap.sum() == 2000 - n_c + 1 and gap[10000:12000 - n_c + 1].all()
        for ds in (fused[s], plain[s]):
            assert np.all(ds[gap] == 0.0)
            assert np.abs(ds[~gap] - o[~gap]).max() <= 2e-5
    th = np.full(2, 0.6, np.float32)
    tscan.ROUTE_COUNTS.clear()
    out_f = tscan.scan_chunks(X, tb, th, NC, 250, max_trig=8)
    monkeypatch.setattr(tds, "FUSED_DS_BYTES", 0)
    monkeypatch.setattr(tds, "FOLD_CB_BYTES", 0)
    out_p = tscan.scan_chunks(X, tb, th, NC, 250, max_trig=8)
    assert dict(tscan.ROUTE_COUNTS) == {"fused-sub+fusedprep": 1,
                                        "plain": 1}
    _check_scan(out_p, out_f, True)
    assert int(out_p[4][0, 1]) == 1 and int(out_p[2][0, 1, 0]) == 20000
