"""detex_torch's dense re-verify held against detex_tpu on the CPU.

The dense re-verify runs a bank over the chunks in which a detector
triggered and extracts the exact triggers: ds.run_bank_triggers_batch (and
run_bank_rows_batch / run_bank_batch) -> os_prep_batch (block forward
transform, kernel rfft_ct_fused) -> os_block_scan_batch (inverse transform
irfft_ct_fused, then ds_finalize_os_fold) -> triggers.trigger_rows_device
(STA/LTA and argmax extraction).

Both packages see the same seeded numpy inputs and, through
bank_from_numpy, identical template spectra. detex_tpu runs its Pallas
kernels in interpret mode (DETEX_TPU_PALLAS=1, DETEX_TPU_MATMUL_FFT=1, as
tests/test_spec_ds.py does) with the block pinned at 16384; the port runs
the kernels' plain PyTorch twins, which is what its wrappers do with CPU
tensors. Chunks are two overlap-save blocks long to keep interpret mode
cheap.

Tolerances: spectra within 2e-3 of a float64 rfft and within 2e-3 plus
detex_tpu's own error of detex_tpu (its bf16x3 matrix DFT is the less exact
side, ROADMAP C8); a atol 1e-4; power rtol 1e-4 / atol 1e-3; DS and block
maxima atol 2e-5 (the engine's gate epsilon) with -inf positions identical;
histogram totals exact with at most 40 edge-ULP bin moves; trigger indices
exact; STA/LTA rtol 1e-5 against detex_tpu (float32 prefix sums there,
float64 here) and bit-identical against the port's own host chain.
"""
import numpy as np
import pytest
import torch

from detex_tpu.ops import ds as jds
from detex_tpu.ops import rolling as jrolling
from detex_tpu.ops import stalta as jstalta
from detex_tpu.ops import triggers as jtrig
from detex_torch.ops import ds as tds
from detex_torch.ops import rolling as trolling
from detex_torch.ops import stalta as tstalta
from detex_torch.ops import triggers as ttrig

NC = 3
N = 1680                      # n_c = 560: pad0 81, D0 640, W 15744
BLK = 16384
L_C = 24000                   # two blocks: out_len 23441 <= 2 W
LC = NC * L_C


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


def _banks(U_list, Lc=LC):
    jb = jds.build_bank(U_list, NC, Lc, prefer_os=True, block_fft=BLK)
    tb = tds.bank_from_numpy({k: (np.asarray(v) if hasattr(v, "shape")
                                  else v) for k, v in jb.items()}, "cpu")
    return jb, tb


def _chunks(rng, U_list, amps=(150.0, 0.0, 150.0)):
    """Noise chunks of LC samples, chunk i with template i % S planted at
    amplitude amps[i]; the second chunk ragged (zero tail)."""
    xs = []
    for i, amp in enumerate(amps):
        x = rng.standard_normal(LC).astype(np.float32)
        if amp:
            u = U_list[i % len(U_list)][0]
            off = NC * (3000 + 7000 * i)
            x[off:off + N] += amp * u.astype(np.float32)
        xs.append(x)
    xs[1] = xs[1][:LC - NC * 4000]
    return xs


@pytest.mark.parametrize("fn", ["rolling_sum_rows", "rolling_mean_centered"])
def test_rolling_matches_jax(fn):
    """Mean-centered float64 window sums against detex_tpu's float32 ones
    on rows with a large offset (where an uncentered float32 prefix would
    lose ~1e-4 relative)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 50000)) + 40.0).astype(np.float32)
    for n in (1, 37, 2000):
        if fn == "rolling_sum_rows":
            t = trolling.rolling_sum_rows(torch.from_numpy(x), n).numpy()
            j = np.asarray(jrolling.rolling_sum_rows(x, n))
            np.testing.assert_allclose(t, j, rtol=2e-6, atol=0)
            assert t.shape == (3, 50000 - n + 1)
        else:
            t = trolling.rolling_mean_centered(torch.from_numpy(x), n).numpy()
            j = np.stack([np.asarray(jrolling.rolling_mean_centered(r, n))
                          for r in x])
            assert np.array_equal(np.isnan(t), np.isnan(j))
            fin = ~np.isnan(j)
            np.testing.assert_allclose(t[fin], j[fin], rtol=2e-6)


def test_os_prep_batch_matches_jax(jax_fused_env):
    """Spectra, window stats and exact zero power on a chunk with a
    zero-filled gap and one with a ragged zero tail."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2, LC)).astype(np.float32)
    X[0, NC * 5000:NC * 8000] = 0.0              # zero-filled gap
    X[1, NC * 20000:] = 0.0                      # ragged zero tail
    n_c = N // NC
    out_len, pad0, D0, W, m = tds._os_geometry(L_C, n_c, BLK)
    F_t, a_t, p_t = (t.numpy() for t in tds.os_prep_batch(
        torch.from_numpy(X), n_c, NC, BLK))
    F_j, a_j, p_j = (np.asarray(t) for t in jds.os_prep_batch(
        X, n_c, NC, BLK))
    R = BLK // 2 + 1
    assert F_t.shape == F_j.shape == (2, NC, m, R)
    assert a_t.shape == p_t.shape == (2, out_len)
    X64 = X.astype(np.float64)
    xs = (X64 - X64.mean(1, keepdims=True)) / X64.std(1, keepdims=True)
    xq = np.zeros((2, NC, m * W + D0))
    xq[:, :, pad0:pad0 + L_C] = xs.reshape(2, L_C, NC).transpose(0, 2, 1)
    F64 = np.stack([np.fft.rfft(xq[..., f * W:f * W + BLK], axis=-1)
                    for f in range(m)], axis=2)
    assert np.abs(F_t - F64).max() <= 2e-3
    assert np.all(np.abs(F_t - F_j) <= 2e-3 + np.abs(F_j - F64))
    np.testing.assert_allclose(a_t, a_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-4, atol=1e-3)
    # power is exactly 0 on precisely the windows whose raw samples are
    # all zero, as in the float64 oracle's rolling sums of the raw chunk
    c2 = np.cumsum(np.insert(X64 * X64, 0, 0.0, axis=1), axis=1)
    zero = (c2[:, N:] - c2[:, :-N] == 0)[:, ::NC]
    assert zero[0].sum() == 3000 - n_c + 1 and zero[1].any()
    assert np.array_equal(p_t == 0, zero)


@pytest.mark.parametrize("nbin", [0, 400])
def test_os_block_scan_batch_matches_jax(jax_fused_env, nbin):
    """One block scan on identical prep arrays (detex_tpu's os_prep_batch
    output fed to both): ds with -inf past nv, block maxima, histograms;
    S = 3 rows (d_mask ragged) per chunk, one chunk empty, one ragged."""
    rng = np.random.default_rng(30 + nbin)
    U_list = _U_list(rng, S=3, D=2)
    jb, tb = _banks(U_list)
    X = np.stack(_chunks(rng, U_list, amps=(150.0, 0.0, 0.0))[:1] * 3)
    n_c = N // NC
    F, a, p = jds.os_prep_batch(X, n_c, NC, BLK)
    out_len = L_C - n_c + 1
    nv = np.array([out_len, 0, out_len - 5000], np.int32)
    d_j, p_j, h_j = jds.os_block_scan_batch(
        F, a, p, jb["Ufd2"], jb["sum_u"], jb["d_mask"], n_c, NC, BLK, L_C,
        nv, nbin=nbin)
    d_t, p_t, h_t = tds.os_block_scan_batch(
        torch.from_numpy(np.array(F)), torch.from_numpy(np.array(a)),
        torch.from_numpy(np.array(p)), tb["Ufd2"], tb["sum_u"],
        tb["d_mask"], n_c, NC, BLK, L_C, torch.from_numpy(nv), nbin=nbin)
    for t, j in ((d_t, d_j), (p_t, p_j)):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape
        assert np.array_equal(np.isfinite(t), np.isfinite(j))
        fin = np.isfinite(j)
        assert fin.any() and np.abs(t[fin] - j[fin]).max() <= 2e-5
    assert float(d_t[0, 0].max()) > 0.5                   # the plant
    if nbin:
        h_t = h_t.numpy().astype(np.int64)
        h_j = np.asarray(h_j).astype(np.int64)
        assert np.array_equal(h_t.sum(-1), h_j.sum(-1))
        assert np.abs(h_t - h_j).sum() <= 40
    else:
        assert h_t is None and h_j is None


@pytest.mark.parametrize("entry,n_chunks", [("rows", 1), ("rows", 3),
                                            ("batch", 3)])
def test_bank_batch_entries_match_jax_and_oracle(jax_fused_env, entry,
                                                 n_chunks):
    """run_bank_rows_batch / run_bank_batch against detex_tpu and the
    float64 oracle ds_numpy; one chunk takes detex_tpu's run_bank_rows."""
    rng = np.random.default_rng(40 + n_chunks)
    U_list = _U_list(rng, S=2, D=2)
    jb, tb = _banks(U_list)
    xs = _chunks(rng, U_list)[:n_chunks]
    if entry == "rows":
        rows = [[0, 1], [1], [0]][:n_chunks]
        got = tds.run_bank_rows_batch(xs, tb, NC, rows)
        want = jds.run_bank_rows_batch(xs, jb, NC, rows)
    else:
        rows = [[0, 1]] * n_chunks
        got = [dict(enumerate(o))
               for o in tds.run_bank_batch(xs, tb, NC)]
        want = [dict(enumerate(o))
                for o in jds.run_bank_batch(xs, jb, NC)]
    assert len(got) == len(want) == n_chunks
    for i, x in enumerate(xs):
        for si in rows[i]:
            t, j = got[i][si], want[i][si]
            o = tds.ds_numpy(x, U_list[si], NC)
            assert t.dtype == np.float32 and t.shape == j.shape == o.shape
            assert np.abs(t - j).max() <= 2e-5
            assert np.abs(t - o).max() <= 2e-5


def test_run_bank_triggers_batch_matches_jax(jax_fused_env):
    """Planted events through both packages' run_bank_triggers_batch, with
    chunks of three valid lengths (three row groups, one empty chunk)."""
    rng = np.random.default_rng(50)
    U_list = _U_list(rng, S=2, D=2)
    jb, tb = _banks(U_list)
    xs = _chunks(rng, U_list) + [np.zeros(0, np.float32)]
    rows = [[0, 1], [0, 1], [0], [1]]
    thrs = [[0.4, 0.4], [0.3, 0.3], [0.4], [0.4]]
    srs = [25.0, 25.0, 20.0, 25.0]
    got = tds.run_bank_triggers_batch(xs, tb, NC, rows, thrs, srs, 10.0,
                                      0.5, True)
    want = jds.run_bank_triggers_batch(xs, jb, NC, rows, thrs, srs, 10.0,
                                       0.5, True)
    assert len(got) == len(want) == 4
    found = 0
    for ci in range(4):
        assert sorted(got[ci]) == sorted(want[ci]) == sorted(rows[ci])
        for si in rows[ci]:
            (ti, tv, ts), (ji, jv, js) = got[ci][si], want[ci][si]
            assert ti.dtype == np.int64 and tv.dtype == ts.dtype == np.float32
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tv, jv, rtol=0, atol=2e-5)
            np.testing.assert_allclose(ts, js, rtol=1e-5)
            found += len(ti)
    assert found == 2                             # the two planted events


@pytest.mark.parametrize("source", ["x_list", "x_dev"])
def test_run_bank_triggers_batch_matches_rows_path(source):
    """run_bank_triggers_batch against the port's own rows path plus the
    host chain (inf-zeroing, ds_stalta, extract_triggers_np): identical
    indices, DS and STA/LTA values. A low threshold on a 5 Hz chunk (buff
    100 samples) gives more than 64 triggers on one row."""
    rng = np.random.default_rng(60)
    U_list = _U_list(rng, S=2, D=2)
    _, tb = _banks(U_list)
    xs = _chunks(rng, U_list) + [np.zeros(0, np.float32)]
    rows = [[0, 1], [1], [0], [0]]
    ref_rows = tds.run_bank_rows_batch(xs, tb, NC, rows)
    low = float(np.quantile(ref_rows[1][1], 0.5))
    thrs = [[0.4, 0.4], [low], [0.4], [0.4]]
    srs = [25.0, 5.0, 25.0, 25.0]
    lta_t, sta_t = 10.0, 0.5
    if source == "x_list":
        got = tds.run_bank_triggers_batch(xs, tb, NC, rows, thrs, srs,
                                          lta_t, sta_t, True)
    else:
        Xd = torch.zeros((len(xs), tb["pad_len"]))
        for i, x in enumerate(xs):
            Xd[i, :len(x)] = torch.from_numpy(x)
        got = tds.run_bank_triggers_batch(
            None, tb, NC, rows, thrs, srs, lta_t, sta_t, True, x_dev=Xd,
            lens_dev=[len(x) for x in xs])
    counts = []
    for ci in range(len(xs)):
        for si, thr in zip(rows[ci], thrs[ci]):
            dsvec = ref_rows[ci][si]
            idx, ds_at, sl_at = got[ci][si]
            if len(dsvec) and dsvec.max() > 1.1:
                dsvec = np.where(np.isfinite(dsvec), dsvec, 0.0)
            want = ttrig.extract_triggers_np(dsvec, thr, int(20 * srs[ci]),
                                             max_triggers=4096)
            np.testing.assert_array_equal(idx, want)
            np.testing.assert_array_equal(ds_at, dsvec[want])
            if len(dsvec):
                sl = tstalta.ds_stalta(torch.from_numpy(dsvec),
                                       lta_t * srs[ci], sta_t * srs[ci])
                np.testing.assert_array_equal(sl_at, sl.numpy()[want])
            else:
                assert len(sl_at) == 0
            counts.append(len(idx))
    assert max(counts) > 64 and counts[-1] == 0


def _trigger_rows(rng):
    """DS-like rows past a valid length L (tests/test_device_triggers.py):
    isolated and clustered peaks, a plateau (first occurrence), edge
    peaks, the inf-zeroing branch, a row without triggers, and a row whose
    NaN maximum neither triggers nor takes the inf-zeroing branch."""
    L, Lv, R = 4000, 4608, 6
    rows = rng.normal(0, 0.05, size=(R, Lv)).astype(np.float32)
    rows[:, L:] = 7.7            # junk past the valid length: must be cut
    rows[0, [100, 900, 2000]] = [0.8, 0.95, 0.5]
    rows[1, 200:220] = 0.9
    rows[2, 10] = 0.7
    rows[2, L - 5] = 0.6
    rows[3, 500] = 2.0           # max > 1.1 -> non-finite values zeroed
    rows[3, 700] = np.inf
    rows[4, :] = 0.01
    rows[5, 300] = 0.9
    rows[5, 1200] = np.nan
    return rows, L


@pytest.mark.parametrize("use_stalta,sta_n", [(True, 13), (True, 1),
                                              (False, 1)])
def test_trigger_rows_device_matches_jax_and_host_chain(use_stalta, sta_n):
    rows, L = _trigger_rows(np.random.default_rng(7))
    thr = np.full(rows.shape[0], 0.4, np.float32)
    lta_n, buff, K = 250, 40, 64
    idx_t, cnt_t, dsv_t, slv_t = (t.numpy() for t in
                                  ttrig.trigger_rows_device(
        torch.from_numpy(rows), torch.from_numpy(thr), L, sta_n, lta_n,
        buff, K, use_stalta))
    idx_j, cnt_j, dsv_j, slv_j = (np.asarray(t) for t in
                                  jtrig.trigger_rows_device(
        rows, thr, L, sta_n, lta_n, buff, K, use_stalta))
    assert cnt_t[4] == cnt_t[5] == 0 and cnt_t[0] >= 3 and cnt_t[1] == 1
    for r in range(rows.shape[0]):
        n = int(cnt_t[r])
        assert n == int(cnt_j[r])
        np.testing.assert_array_equal(idx_t[r, :n], idx_j[r, :n])
        assert np.all(idx_t[r, n:] == -1)
        np.testing.assert_array_equal(dsv_t[r, :n], dsv_j[r, :n])
        row = rows[r, :L]
        if row.max() > 1.1:
            row = np.where(np.isfinite(row), row, 0.0).astype(np.float32)
        want = ttrig.extract_triggers_np(row, 0.4, buff, max_triggers=K)
        np.testing.assert_array_equal(idx_t[r, :n], want)
        if use_stalta:
            np.testing.assert_allclose(slv_t[r, :n], slv_j[r, :n],
                                       rtol=1e-5)
            sl = tstalta.ds_stalta(torch.from_numpy(row), lta_n, sta_n)
            np.testing.assert_array_equal(slv_t[r, :n], sl.numpy()[want])
            j = np.asarray(jstalta.ds_stalta(row, lta_n, sta_n))
            np.testing.assert_allclose(sl.numpy(), j, rtol=1e-5)


def test_dense_path_raises_on_unported_forms(monkeypatch):
    """A dict that is no bank form (an overlap-save bank without its flag)
    raises ValueError on every dense entry; the full-length and
    multiplexed forms run (tests/test_torch_fullbank.py). Geometries and
    batch sizes detex_tpu serves with its per-chunk fallback run
    (tests/test_torch_chunk.py); the batch above the inverse-block cap goes
    one chunk at a time without raising."""
    rng = np.random.default_rng(8)
    U_list = _U_list(rng, S=1, D=1)
    x = [rng.standard_normal(LC).astype(np.float32)]
    _, tb = _banks(U_list)
    full = dict(tb, os=False)
    for call in (lambda: tds.run_bank_batch(x, full, NC),
                 lambda: tds.run_bank_rows_batch(x * 2, full, NC,
                                                 [[0], [0]]),
                 lambda: tds.run_bank(x[0], full, NC),
                 lambda: tds.run_bank_rows(x[0], full, NC, [0])):
        with pytest.raises(ValueError, match="not an overlap-save"):
            call()
    want = tds.run_bank_rows_batch(x * 2, tb, NC, [[0], [0]])
    monkeypatch.setattr(tds, "FOLD_CB_BYTES", 2 * BLK * 4 - 1)
    got = tds.run_bank_rows_batch(x * 2, tb, NC, [[0], [0]])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2e-5)
