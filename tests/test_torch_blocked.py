"""detex_torch's template-blocked scans (past TEMPLATE_BLOCK = 128
templates) held against detex_tpu on the CPU.

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra, with the block pinned on
both sides (ROADMAP C1). The batch routes ("blocked-fused-net+fusedprep",
"blocked-fold") need detex_tpu's Pallas switches (DETEX_TPU_PALLAS=1,
DETEX_TPU_MATMUL_FFT=1: its kernels in interpret mode); the per-chunk
route runs without them. The port runs its kernels' plain PyTorch twins.

Tolerances: route names equal, histogram row totals exact with at most 40
edge-ULP bin moves (floor rule against np.histogram's), maxima within
2e-5 with -inf positions identical, trigger indices and counts exact.
At S = 1000 the blocked scan is held, bit for bit, against the same bank
scanned as eight banks of 128 through the unblocked route.
"""
import json

import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_tpu.parallel import scan as jscan
from detex_torch import serving as tserving
from detex_torch.ops import ds as tds
from detex_torch.parallel import scan as tscan

NC = 3
N = 1680                      # multiplexed template length (n_c = 560)
LC = 3 * 35000


def _U_list(rng, S, D, n=N):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)      # ragged -> d_mask
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def _banks(U_list, Lc, blk, prefer_os=True):
    jb = jds.build_bank(U_list, NC, Lc, prefer_os=prefer_os, block_fft=blk)
    tb = tds.bank_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                  else v) for k, v in jb.items()}, "cpu")
    return jb, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_scan(out_t, out_j):
    h_t, m_t, ti_t, tv_t, tc_t = map(_np, out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    assert h_t.shape == h_j.shape and h_t.dtype == np.int32
    assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
    assert np.abs(h_t.astype(np.int64) - h_j).sum() <= 40
    assert m_t.shape == m_j.shape
    assert np.array_equal(np.isfinite(m_t), np.isfinite(m_j))
    fin = np.isfinite(m_j)
    assert np.abs(m_t[fin] - m_j[fin]).max() <= 2e-5
    assert np.array_equal(ti_t, ti_j) and np.array_equal(tc_t, tc_j)
    k = ti_j >= 0
    assert k.any() and np.abs(tv_t[k] - tv_j[k]).max() <= 2e-5


def _chunks(rng, U_list, B, Lc, plant):
    """B chunks of noise, an event of template ``plant`` in chunk 0 (DS ~
    0.9) and the last chunk ragged."""
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    n = U_list[plant].shape[1]
    off = NC * (Lc // NC // 3)
    X[0, off:off + n] += 3.0 * np.sqrt(n) * U_list[plant][0]
    lens = [Lc] * B
    lens[-1] = Lc - NC * 3000
    X[-1, lens[-1]:] = 0.0
    return X, lens


# case -> (route name, blk (0: full-length bank), L_c, B, bins, Pallas)
# blk 8192 has no fused kernel geometry, so the blocked batch takes the
# unfused "blocked-fold"; squared bins send an overlap-save bank one chunk
# at a time; a full-length bank always goes one chunk at a time
ROUTES = {
    "fused-net": ("blocked-fused-net+fusedprep", 16384, 12000, 2, None,
                  True),
    "fold": ("blocked-fold", 8192, 12000, 2, None, True),
    "plain-bins": ("plain", 16384, 12000, 2, np.linspace(0, 1, 11) ** 2,
                   False),
    "plain-fullbank": ("plain", 0, 12000, 2, None, False),
}


@pytest.mark.parametrize("S", [129, 256])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_blocked_routes_match_jax(monkeypatch, case, S):
    """scan_chunks of an S-template bank on each template-blocked route
    against detex_tpu's: the planted template in the last block, one ragged
    chunk."""
    route, blk, L_c, B, bins, pallas = ROUTES[case]
    if pallas:
        monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
        monkeypatch.setenv("DETEX_TPU_MATMUL_FFT", "1")
    rng = np.random.default_rng(S + blk + L_c)
    U_list = _U_list(rng, S, 1)
    jb, tb = _banks(U_list, NC * L_c, blk, prefer_os=bool(blk))
    assert tds.bank_kind(tb) == ("os" if blk else "demux")
    X, lens = _chunks(rng, U_list, B, NC * L_c, plant=S - 1)
    th = np.full(S, 0.6, np.float32)
    kw = dict(bins=bins, max_trig=8, valid_lens=lens)
    tscan.ROUTE_COUNTS.clear()
    jscan.ROUTE_COUNTS.clear()
    out_t = tscan.scan_chunks(X, tb, th, NC, 250, **kw)
    out_j = jscan.scan_chunks(X, dict(jb), th, NC, 250, **kw)
    assert dict(tscan.ROUTE_COUNTS) == {route: 1}
    assert dict(jscan.ROUTE_COUNTS) == {route: 1}
    assert tuple(out_t[1].shape) == (B, S)
    _check_scan(out_t, out_j)
    assert int(out_t[4][0, S - 1]) == 1
    assert int(out_t[2][0, S - 1, 0]) == int(np.nanargmax(
        tds.ds_numpy(X[0], U_list[S - 1], NC)))


@pytest.mark.parametrize("case", ["blocked", "fullbank"])
def test_past_one_block_scans(case):
    """The inputs that raised NotImplementedError before the blocked routes
    (S = 129 zero-padded rows of one template on an overlap-save bank, and
    on a full-length bank) now scan: the blocked batch and the per-chunk
    route over two blocks, with every maximum 0 on zero chunks."""
    X = np.zeros((2, LC), np.float32)
    rng = np.random.default_rng(5 if case == "blocked" else 6)
    U = _U_list(rng, 1, 1)
    if case == "blocked":
        bank = tds.build_bank(_U_list(rng, 129, 1), NC, LC, "cpu",
                              block_fft=16384)
        want = "blocked-fused-net+fusedprep"
    else:
        bank = tds.build_bank(U, NC, LC, "cpu", block_fft=0, pad_S=129)
        assert tds.bank_kind(bank) == "demux"
        want = "plain"
    tscan.ROUTE_COUNTS.clear()
    hist, maxds, ti, _, tc = tscan.scan_chunks(X, bank, np.ones(129), NC,
                                               buff_samps=250, max_trig=4)
    assert dict(tscan.ROUTE_COUNTS) == {want: 1}
    assert tuple(hist.shape) == (129, 400) and tuple(maxds.shape) == (2, 129)
    assert bool((hist.sum(1) == 2 * (35000 - 560 + 1)).all())
    assert bool((maxds == 0).all()) and not bool(tc.any())
    assert tuple(ti.shape) == (2, 129, 4)


@pytest.mark.parametrize("calc_triggers", [True, False])
def test_s1000_blocked_equals_per_block_scans(calc_triggers):
    """The bench.py network geometry at short chunks: 1000 single-template
    detectors padded to pad_rows(1000) = 1024 (8 blocks). The blocked
    route's histogram, maxima and triggers equal, bit for bit, those of
    the same bank scanned as eight banks of 128 (slices of its arrays)
    through the unblocked fused route."""
    rng = np.random.default_rng(1000)
    S, L_c, B = 1000, 12000, 2
    U_list = _U_list(rng, S, 1)
    bank = tds.build_bank(U_list, NC, NC * L_c, "cpu",
                          pad_S=tds.pad_rows(S))
    Sp = int(bank["sum_u"].shape[0])
    assert Sp == 1024
    X = rng.standard_normal((B, NC * L_c)).astype(np.float32)
    for b, s in ((0, 3), (1, 517), (1, 999)):
        off = NC * (2000 + 5 * s)
        X[b, off:off + N] += 3.0 * np.sqrt(N) * U_list[s][0]
    th = np.full(Sp, 0.6, np.float32)
    th[S:] = np.inf
    kw = dict(max_trig=4, calc_triggers=calc_triggers)
    tscan.ROUTE_COUNTS.clear()
    got = tscan.scan_chunks(X, bank, th, NC, 250, **kw)
    assert dict(tscan.ROUTE_COUNTS) == {"blocked-fused-net+fusedprep": 1}
    parts = []
    for i in range(0, Sp, 128):
        sub = {k: v for k, v in bank.items() if not k.startswith("_")}
        for k in ("Ufd2", "sum_u", "d_mask"):
            sub[k] = bank[k][i:i + 128]
        parts.append(tscan.scan_chunks(X, sub, th[i:i + 128], NC, 250, **kw))
    assert tscan.ROUTE_COUNTS["fused-net+fusedprep"] == 8
    assert torch.equal(got[0], torch.cat([p[0] for p in parts]))
    for k in range(1, 5):     # maxds, trigger indices, values, counts
        torch.testing.assert_close(
            got[k], torch.cat([p[k] for p in parts], dim=1), rtol=0, atol=0,
            equal_nan=True)
    if calc_triggers:
        for b, s in ((0, 3), (1, 517), (1, 999)):
            assert int(got[4][b, s]) == 1
        assert int(got[4].sum()) == 3


def test_serving_station_past_one_block(tmp_path):
    """load_detectors packs a 130-detector station of one template length
    into one bank of 130 rows; scan_station scans it (the blocked route)
    and finds the planted events against detex_tpu's serving scan."""
    rng = np.random.default_rng(130)
    sr, S, B = 25.0, 130, 2
    U_list = _U_list(rng, S, 1)
    meta = {"stations": {"XX.S01": {"nc": NC, "sr": sr, "detectors": [
        dict(name="SG%03d" % s, kind="sg", threshold=0.5, offsets=[0.0],
             mags=[1.0], events=["ev%d" % s]) for s in range(S)]}},
        "filt": [1, 8, 2, True], "decimate": 1, "version": 1}
    arrays = {"U__XX.S01__SG%03d" % s: U_list[s].astype(np.float32)
              for s in range(S)}
    arrays["meta"] = np.array(json.dumps(meta))
    path = str(tmp_path / "detectors.npz")
    np.savez(path, **arrays)
    dep = tserving.load_detectors(path, chunk_sec=1200, conBuff=100,
                                  device="cpu")
    bank = dep["XX.S01"]["banks"][0]
    assert len(bank["names"]) == S and int(bank["sum_u"].shape[0]) == S
    X = rng.standard_normal((B, int(1300 * sr * NC))).astype(np.float32)
    for b, s in ((0, 7), (1, 129)):
        X[b, 30000:30000 + N] += 150.0 * U_list[s][0]
    tscan.ROUTE_COUNTS.clear()
    res = tserving.scan_station(dep, "XX.S01", X, max_trig=8)
    assert dict(tscan.ROUTE_COUNTS) == {"blocked-fused-net+fusedprep": 1}
    r = res[0]
    assert r["maxds"].shape == (B, S) and r["hist"].shape == (S, 400)
    assert np.array_equal(r["hist"].sum(1), np.full(S, B * (
        X.shape[1] // NC - N // NC + 1)))
    for b, s in ((0, 7), (1, 129)):
        assert r["trig_count"][b, s] == 1
        o = tds.ds_numpy(X[b].astype(np.float64), U_list[s], NC)
        assert int(r["trig_idx"][b, s, 0]) == int(np.nanargmax(o))
        assert abs(float(r["trig_val"][b, s, 0]) - np.nanmax(o)) <= 2e-5
    assert int(r["trig_count"].sum()) == 2
    rows = tserving.triggers_to_frame(dep, "XX.S01", res, [100.0, 5000.0])
    assert [(x["Name"], x["STMP"]) for x in rows] == [
        ("SG007", 100.0 + int(r["trig_idx"][0, 7, 0]) / sr),
        ("SG129", 5000.0 + int(r["trig_idx"][1, 129, 0]) / sr)]
