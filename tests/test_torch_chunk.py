"""detex_torch's per-chunk overlap-save routes held against detex_tpu on the
CPU: the single-chunk DS (ds_bank_demux_os, run_bank, run_bank_rows, the
dense re-verify's per-chunk fallback), the per-chunk scan ("plain": os_prep
+ os_block_scan + _hist_rows), the fused scan behind the unfused prep
(os_prep_batch_pair + rfft_pair) and the unfused "fold" batch at a block
the transform kernels do not take, plus the route choice itself.

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra; the block is pinned on both
sides (ROADMAP C1). Without its Pallas switches detex_tpu takes its
per-chunk route for every scan on the CPU, with XLA transforms and
finalize, so the value tests compare every port route against that; the
route-choice test sets the switches (DETEX_TPU_PALLAS=1,
DETEX_TPU_MATMUL_FFT=1) and only asks detex_tpu for its route. The port
runs its kernels' plain PyTorch twins, which is what its wrappers do with
CPU tensors.

Tolerances: DS and maxima atol 2e-5 (the engine's gate epsilon) with -inf
positions identical; histogram row totals exact with at most 40 edge-ULP
bin moves (floor rule against np.histogram's); trigger indices and counts
exact; the float64 oracle ds_numpy within 2e-5.
"""
import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_tpu.ops import pallas_kernels as jpk
from detex_tpu.parallel import scan as jscan
from detex_torch.ops import dft as tdft
from detex_torch.ops import ds as tds
from detex_torch.parallel import scan as tscan

NC = 3


@pytest.fixture()
def jax_fused_env(monkeypatch):
    monkeypatch.setenv("DETEX_TPU_PALLAS", "1")
    monkeypatch.setenv("DETEX_TPU_MATMUL_FFT", "1")
    yield


def _U_list(rng, S, D, n):
    out = []
    for s in range(S):
        d = D if s % 2 == 0 else max(1, D - 1)      # ragged -> d_mask
        q, _ = np.linalg.qr(rng.standard_normal((d, n)).T)
        out.append(np.ascontiguousarray(q[:, :d].T))
    return out


def _banks(U_list, Lc, blk):
    jb = jds.build_bank(U_list, NC, Lc, prefer_os=True, block_fft=blk)
    tb = tds.bank_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                  else v) for k, v in jb.items()}, "cpu")
    return jb, tb


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(t, j, atol=2e-5):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    assert np.array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    if fin.any():
        assert np.abs(t[fin] - j[fin]).max() <= atol
    assert np.array_equal(t[~fin], j[~fin])


# (blk, n_c, L_c): W = 15744 (scan form of the per-chunk finalize) and
# W = 32128 > 16384 (W // 128 > 128: the finalize without mask, then the
# separate histogram)
GEOMS = {"w15744": (16384, 560, 24000), "w32128": (32768, 560, 40000)}


def _chunk(rng, U, L_c, off):
    x = rng.standard_normal(NC * L_c).astype(np.float32)
    x[NC * off:NC * off + U.shape[1]] += 150.0 * U[0].astype(np.float32)
    return x


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_ds_bank_demux_os_matches_jax_and_oracle(geom):
    """The single-chunk DS (os_prep + _os_block, ds_finalize_os's twin)
    against detex_tpu's ds_bank_demux_os and the float64 oracle."""
    blk, n_c, L_c = GEOMS[geom]
    rng = np.random.default_rng(blk)
    U_list = _U_list(rng, 3, 2, NC * n_c)
    jb, tb = _banks(U_list, NC * L_c, blk)
    x = _chunk(rng, U_list[2], L_c, 7000)
    t = tds.ds_bank_demux_os(torch.from_numpy(x), tb["Ufd2"], tb["sum_u"],
                             tb["d_mask"], n_c, NC, blk)
    j = jds.ds_bank_demux_os(x, jb["Ufd2"], jb["sum_u"], jb["d_mask"], n_c,
                             NC, blk)
    assert tuple(t.shape) == (3, L_c - n_c + 1)
    _close(t, j)
    for s in range(3):
        o = tds.ds_numpy(x, U_list[s], NC)
        assert np.abs(_np(t[s]) - o).max() <= 2e-5
    assert np.nanargmax(_np(t[2])) == 7000


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_run_bank_and_rows_match_jax_and_oracle(geom):
    """run_bank / run_bank_rows on a chunk shorter than the bank's pad_len
    (zero-padded, cut to its valid windows) and run_bank_rows_batch with
    one chunk, which now takes run_bank_rows as in detex_tpu."""
    blk, n_c, L_c = GEOMS[geom]
    rng = np.random.default_rng(blk + 1)
    U_list = _U_list(rng, 3, 2, NC * n_c)
    jb, tb = _banks(U_list, NC * L_c, blk)
    x = _chunk(rng, U_list[0], L_c, 4000)[:NC * (L_c - 3000)]
    t = tds.run_bank(x, tb, NC)
    j = np.asarray(jds.run_bank(x, jb, NC))
    assert t.dtype == np.float32 and t.shape == j.shape
    assert t.shape == (3, L_c - 3000 - n_c + 1)
    _close(t, j)
    rows_t = tds.run_bank_rows(x, tb, NC, [2, 0])
    rows_j = jds.run_bank_rows(x, jb, NC, [2, 0])
    batch_t = tds.run_bank_rows_batch([x], tb, NC, [[2, 0]])[0]
    assert sorted(rows_t) == sorted(rows_j) == sorted(batch_t) == [0, 2]
    for s in (0, 2):
        o = tds.ds_numpy(x, U_list[s], NC)
        _close(rows_t[s], rows_j[s])
        assert np.array_equal(batch_t[s], rows_t[s])
        assert np.abs(rows_t[s] - o).max() <= 2e-5
    assert np.nanargmax(rows_t[0]) == 4000


@pytest.mark.parametrize("geom,nbin", [("w15744", 0), ("w15744", 400),
                                       ("w32128", 400)])
def test_os_block_scan_matches_jax(geom, nbin):
    """os_block_scan and ds_bank_demux_os_scan against detex_tpu's with a
    ragged valid length: ds with -inf past nv, block maxima, and the
    finalize's histogram (W // 128 <= 128 only) against np.histogram of
    detex_tpu's DS."""
    blk, n_c, L_c = GEOMS[geom]
    rng = np.random.default_rng(blk + nbin)
    U_list = _U_list(rng, 3, 2, NC * n_c)
    jb, tb = _banks(U_list, NC * L_c, blk)
    x = _chunk(rng, U_list[1], L_c, 2000)
    nv = L_c - n_c + 1 - 1500
    F, a, power = tds.os_prep(torch.from_numpy(x), n_c, NC, blk)
    ds_t, pyr_t, h_t = tds.os_block_scan(
        F, a, power, tb["Ufd2"], tb["sum_u"], tb["d_mask"], n_c, NC, blk,
        L_c, nv, nbin=nbin)
    jF, ja, jp = jds.os_prep(x, n_c, NC, blk)
    ds_j, pyr_j, _ = jds.os_block_scan(
        jF, ja, jp, jb["Ufd2"], jb["sum_u"], jb["d_mask"], n_c, NC, blk, L_c,
        np.int32(nv))
    _close(ds_t, ds_j)
    _close(pyr_t, pyr_j)
    assert bool(torch.isneginf(ds_t[:, nv:]).all())
    ds_1, pyr_1, _ = tds.ds_bank_demux_os_scan(
        torch.from_numpy(x), nv, tb["Ufd2"], tb["sum_u"], tb["d_mask"], n_c,
        NC, blk)
    assert torch.equal(ds_1, ds_t) and torch.equal(pyr_1, pyr_t)
    W = blk - (n_c - 1 + (-(n_c - 1)) % 128)
    if nbin and W // 128 <= 128:
        want = np.stack([np.histogram(r[np.isfinite(r)],
                                      np.linspace(0, 1, nbin + 1))[0]
                         for r in np.asarray(ds_j)])
        assert np.array_equal(_np(h_t).sum(1), want.sum(1))
        assert np.abs(_np(h_t) - want).sum() <= 40
    else:
        assert h_t is None


def _check_scan(out_t, out_j, calc_triggers):
    h_t, m_t, ti_t, tv_t, tc_t = map(_np, out_t)
    h_j, m_j, ti_j, tv_j, tc_j = map(np.asarray, out_j)
    assert h_t.shape == h_j.shape and h_t.dtype == np.int32
    assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
    assert np.abs(h_t.astype(np.int64) - h_j).sum() <= 40
    _close(m_t, m_j)
    assert ti_t.shape == ti_j.shape and tc_t.shape == tc_j.shape
    assert np.array_equal(ti_t, ti_j) and np.array_equal(tc_t, tc_j)
    if calc_triggers:
        k = ti_j >= 0
        assert k.any() and np.abs(tv_t[k] - tv_j[k]).max() <= 2e-5
        assert np.all(np.isnan(tv_t[~k]))


# route case -> (route name, blk, n_c, L_c, S, D, B, bins, tiny caps):
# "plain" at W = 15744 needs the caps that send a large batch one chunk at
# a time (here shrunk below one chunk); n_c = 9000 > W = 7296 makes the
# fused prep refuse the geometry, so the fused kernel takes the unfused
# prep (rfft_pair); blk 8192 has no transform kernel (torch.fft + B3)
SCAN_CASES = {
    "plain-w15744": ("plain", 16384, 560, 24000, 3, 2, 3, None, True),
    "plain-w32128": ("plain", 32768, 560, 40000, 3, 2, 3, None, False),
    "plain-bins": ("plain", 16384, 560, 24000, 3, 2, 3,
                   np.linspace(0, 1, 11) ** 2, False),
    "fused-sub": ("fused-sub", 16384, 9000, 24000, 3, 1, 3, None, False),
    "fused-net": ("fused-net", 16384, 9000, 24000, 8, 1, 2, None, False),
    "fold-8192": ("fold", 8192, 560, 24000, 3, 2, 3, None, False),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
@pytest.mark.parametrize("calc_triggers", [True, False])
def test_scan_chunks_routes_match_jax(monkeypatch, case, calc_triggers):
    """scan_chunks on each route the port adds, against detex_tpu's
    per-chunk scan on the same chunks (one planted event, one ragged
    chunk, one empty padded chunk); the planted maxds and trigger also
    against the float64 oracle."""
    route, blk, n_c, L_c, S, D, B, bins, tiny = SCAN_CASES[case]
    if tiny:
        monkeypatch.setattr(tds, "FUSED_DS_BYTES", 0)
        monkeypatch.setattr(tds, "FOLD_CB_BYTES", 0)
    rng = np.random.default_rng(blk + n_c + S + int(calc_triggers))
    n = NC * n_c
    U_list = _U_list(rng, S, D, n)
    Lc = NC * L_c
    jb, tb = _banks(U_list, Lc, blk)
    X = rng.standard_normal((B, Lc)).astype(np.float32)
    off = NC * (L_c // 3)
    X[0, off:off + n] += 3.0 * np.sqrt(n) * U_list[S - 1][0]   # DS ~ 0.9
    lens = [Lc] * B
    lens[1] = Lc - NC * 3000
    X[1, lens[1]:] = 0.0
    if B > 2:
        lens[2] = 0
        X[2] = 0.0
    th = np.full(S, 0.6, np.float32)
    kw = dict(bins=bins, max_trig=8, valid_lens=lens,
              calc_triggers=calc_triggers)
    tscan.ROUTE_COUNTS.clear()
    out_t = tscan.scan_chunks(X, tb, th, NC, 250, **kw)
    out_j = jscan.scan_chunks(X, dict(jb), th, NC, 250, **kw)
    assert dict(tscan.ROUTE_COUNTS) == {route: 1}
    _check_scan(out_t, out_j, calc_triggers)
    o = tds.ds_numpy(X[0], U_list[S - 1], NC)
    assert abs(np.nanmax(o) - float(out_t[1][0, S - 1])) <= 2e-5
    if calc_triggers:
        assert int(out_t[4][0, S - 1]) >= 1
        assert int(out_t[2][0, S - 1, 0]) == np.nanargmax(o)
    else:
        assert tuple(out_t[2].shape) == (B, S, 0)
    if B > 2:
        assert bool(torch.isneginf(out_t[1][2]).all())


# route-choice geometries: (B, S, D, n_c, blk, L_c, uniform bins) -> the
# route both packages take, or (port's, detex_tpu's) where detex_tpu's
# Pallas tile budgets bind and the port's kernels have none (ROADMAP C20)
ROUTE_CASES = {
    "sub+fp": ((8, 3, 2, 560, 16384, 24000, True), "fused-sub+fusedprep"),
    "net+fp": ((4, 8, 2, 560, 16384, 24000, True), "fused-net+fusedprep"),
    "sub-pair": ((8, 3, 1, 9000, 16384, 24000, True), "fused-sub"),
    "net-pair": ((2, 8, 1, 9000, 16384, 24000, True), "fused-net"),
    "bins": ((8, 3, 2, 560, 16384, 24000, False), "plain"),
    "wide": ((8, 3, 2, 560, 32768, 40000, True), "plain"),
    "fold-8192": ((3, 2, 2, 560, 8192, 24000, True), "fold"),
    "fused-cap": ((1024, 8, 1, 3000, 16384, 372000, True), "plain"),
    "fold-cap": ((8200, 2, 1, 560, 8192, 24000, True), "plain"),
    "sub-any-B": ((3, 3, 2, 560, 16384, 24000, True),
                  ("fused-sub+fusedprep", "fold")),
    "vmem-32768": ((8, 1, 1, 16300, 32768, 40000, True),
                   ("fused-sub+fusedprep", "fold")),
    "fold-tile": ((3, 3, 16, 560, 8192, 24000, True), ("fold", "plain")),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_choice_matches_jax(jax_fused_env, case):
    """The route name scan_chunks would take, from both packages'
    _os_fold_route (detex_tpu with its Pallas switches on: shapes and
    bank spectra only, nothing is scanned)."""
    (B, S, D, n_c, blk, L_c, uniform), want = ROUTE_CASES[case]
    want_t, want_j = want if isinstance(want, tuple) else (want, want)
    rng = np.random.default_rng(S + D)
    jb, tb = _banks(_U_list(rng, S, D, NC * n_c), NC * L_c, blk)
    unb = 400 if uniform else 0
    th = np.ones(S, np.float32)
    r, mode, _, _ = jscan._os_fold_route(
        jb, jscan._bank_statics(jb, NC), B, NC * L_c, True, unb, th)
    assert jscan.route_name(r, mode) == want_j
    r, mode, _, _ = tscan._os_fold_route(
        tb, tscan._bank_statics(tb, NC), B, L_c, unb, th)
    assert tscan.route_name(r, mode) == want_t


@pytest.mark.parametrize("bins", ["uniform", "squares"])
def test_hist_rows_matches_numpy_and_jax(bins):
    """_hist_rows: the floor rule (hist_uniform's twin) against detex_tpu's
    hist_uniform Pallas kernel in interpret mode, exactly, and against
    np.histogram within edge moves; non-uniform bins (_hist_counts)
    against np.histogram exactly. Rows hold -inf, NaN-free values outside
    [0, 1] and exact 0.0 / 1.0."""
    rng = np.random.default_rng(17)
    v = rng.uniform(-0.2, 1.2, (3, 5000)).astype(np.float32)
    v[0, :50] = 1.0
    v[0, 50:60] = 0.0
    v[1, ::9] = -np.inf
    v[2, 4000:] = -np.inf
    edges = (np.linspace(0, 1, 401) if bins == "uniform"
             else np.linspace(0, 1, 31) ** 2)
    unb = tscan._uniform_nbin(edges)
    assert unb == (400 if bins == "uniform" else 0)
    h = _np(tscan._hist_rows(torch.from_numpy(v),
                             torch.as_tensor(edges, dtype=torch.float32),
                             unb))
    want = np.stack([np.histogram(r, edges.astype(np.float32))[0]
                     for r in v])
    assert h.dtype == np.int32 and h.shape == want.shape
    if unb:
        j = np.asarray(jpk.hist_uniform(v, nbin=400, interpret=True))
        assert np.array_equal(h, j.astype(np.int32))
        assert np.array_equal(h.sum(1), want.sum(1))
        assert np.abs(h - want).sum() <= 40
        assert h[0, -1] >= 50
    else:
        assert np.array_equal(h, want)


@pytest.mark.parametrize("n", [16384, 8192])
def test_rfft_pair_matches_float64_rfft(n):
    """dft.rfft_pair (rfft_ct_half's twin at 16384, torch.fft at 8192):
    bins 0..n/2 of a float64 rfft within 2e-3, zeros past them."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n)).astype(np.float32)
    x[3, 200:] = 0.0
    rp = tdft.half_rp(n)
    fr, fi = tdft.rfft_pair(torch.from_numpy(x), n, rp)
    assert tuple(fr.shape) == tuple(fi.shape) == (4, rp)
    f64 = np.fft.rfft(x.astype(np.float64), axis=-1)
    R = n // 2 + 1
    assert np.abs(_np(fr)[:, :R] - f64.real).max() <= 2e-3
    assert np.abs(_np(fi)[:, :R] - f64.imag).max() <= 2e-3
    assert np.all(_np(fr)[:, R:] == 0) and np.all(_np(fi)[:, R:] == 0)
    with pytest.raises(ValueError):
        tdft.rfft_pair(torch.from_numpy(x), n, n // 2)


@pytest.mark.parametrize("n,W,m", [(16384, 7296, 3), (32768, 26752, 2),
                                   (8192, 4096, 3), (16384, 16384, 2)])
def test_rfft_frames_equal_rfft_of_unfold(n, W, m):
    """dft.rfft_frames and dft.rfft_pair_frames on the CPU are exactly
    dft.rfft_ct and dft.rfft_pair of the unfolded (copied) frames: at the
    kernels' block lengths (the twins), at 8192 (torch.fft) and with frames
    that do not overlap; rows longer than the frames need, two leading
    dimensions."""
    rng = np.random.default_rng(n + W)
    xq = torch.from_numpy(rng.standard_normal(
        (2, 3, (m - 1) * W + n + 128)).astype(np.float32))
    frames = xq.unfold(2, n, W)[:, :, :m]
    F = tdft.rfft_frames(xq, n, W, m)
    assert tuple(F.shape) == (2, 3, m, n // 2 + 1)
    assert torch.equal(F, tdft.rfft_ct(frames, n))
    rp = tdft.half_rp(n)
    fr, fi = tdft.rfft_pair_frames(xq, n, W, m, rp)
    wr, wi = tdft.rfft_pair(frames.reshape(-1, n), n, rp)
    assert tuple(fr.shape) == (6 * m, rp)
    assert torch.equal(fr, wr) and torch.equal(fi, wi)
    with pytest.raises(ValueError):
        tdft.rfft_frames(xq, n, W, m + 1)


@pytest.mark.parametrize("n", [16384, 32768])
def test_stage_twiddles_match_float64(n):
    """dft.stage_twiddles: the forward kernels' per-pass roots of unity at
    the places fft_regs.cuh reads them, within float32 rounding of the
    float64 values."""
    tab = _np(tdft.stage_twiddles(n, "cpu")).astype(np.float64)
    M, T, R2 = n // 2, n // 64, n // 1024
    assert tab.shape == (16 * R2 + M, 2)
    z = tab[:, 0] + 1j * tab[:, 1]
    for r, j in ((0, 5), (1, 1), (R2 - 1, 15), (7, 9)):
        want = np.exp(-2j * np.pi * r * j / (16 * R2))
        assert abs(z[r * 16 + j] - want) <= 1e-7
    for r, t in ((0, 3), (1, 1), (31, T - 1), (17, 200), (2, T // 2)):
        want = np.exp(-2j * np.pi * r * t / M)
        assert abs(z[16 * R2 + r * T + t] - want) <= 1e-7
    assert np.abs(np.abs(z) - 1).max() <= 1e-7
    with pytest.raises(ValueError):
        tdft.stage_twiddles(8192, "cpu")


def test_forward_wrappers_check_the_frame_geometry():
    """The forward transform wrappers refuse, on any device, a stride or
    row length off the 16-byte boundary the kernels load by, frames that
    do not fit their rows, and a contiguous input that is not [N, n]."""
    from detex_torch.ops import cuda_kernels as tck
    x = torch.zeros((2, 16384 + 4 * 130))
    for fn in (tck.rfft_ct_fused, tck.rfft_ct_half):
        with pytest.raises(ValueError):
            fn(x, 16384, stride=130, frames=3)
        with pytest.raises(ValueError):
            fn(x[:, :-2], 16384, stride=128, frames=3)
        with pytest.raises(ValueError):
            fn(x, 16384, stride=128, frames=6)
        with pytest.raises(ValueError):
            fn(x, 16384)
        out = fn(x, 16384, stride=128, frames=5)
        assert (out if torch.is_tensor(out) else out[0]).shape[0] == 10


@pytest.mark.parametrize("case", ["fold-8192", "per-chunk"])
def test_dense_entries_beyond_the_caps_match_jax(monkeypatch, case):
    """run_bank_batch / run_bank_rows_batch / run_bank_triggers_batch
    where the batch path's transforms are torch.fft (blk 8192) and where
    the inverse blocks exceed FOLD_CB_BYTES (a loop of ds_bank_demux_os
    over the chunks, detex_tpu's _ds_map_demux_os): against detex_tpu and
    the float64 oracle."""
    blk = 8192 if case == "fold-8192" else 16384
    if case == "per-chunk":
        monkeypatch.setattr(tds, "FOLD_CB_BYTES", 0)
    n_c, L_c = 560, 24000
    rng = np.random.default_rng(blk + 3)
    U_list = _U_list(rng, 2, 2, NC * n_c)
    jb, tb = _banks(U_list, NC * L_c, blk)
    xs = [_chunk(rng, U_list[i % 2], L_c, 3000 + 9000 * i) for i in range(3)]
    xs[1] = xs[1][:NC * (L_c - 4000)]
    got = tds.run_bank_batch(xs, tb, NC)
    want = jds.run_bank_batch(xs, jb, NC)
    rows = tds.run_bank_rows_batch(xs, tb, NC, [[0, 1], [1], [0]])
    for i, x in enumerate(xs):
        _close(got[i], want[i])
        for s in range(2):
            assert np.abs(got[i][s] - tds.ds_numpy(x, U_list[s], NC)).max() \
                <= 2e-5
        for s, r in rows[i].items():
            assert np.array_equal(r, got[i][s])
    trig = tds.run_bank_triggers_batch(xs, tb, NC, [[0], [1], [0]],
                                       [[0.5], [0.5], [0.5]], [25.0] * 3,
                                       10.0, 0.5, True)
    assert [int(trig[i][i % 2][0][0]) for i in (0, 2)] == [3000, 21000]
    assert len(trig[1][1][0]) == 1
