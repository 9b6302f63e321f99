"""detex_torch's correlation ops (ops/xcorr.py, ops/subsample.py) on the
CPU against detex_tpu's and against a float64 numpy oracle of the
reference _CCX2 (construct.py:425-466, as tests/test_xcorr.py writes it).

Tolerances: xcorr_all_pairs against detex_tpu's on both pair paths (N =
12, n = 3000 polyphase and 3001 full, nc = 3) cc 1e-5 and subsample 1e-4,
lags exact wherever the oracle's peak leads its runner-up by more than
1e-5 (two float32 implementations may pick either of near-equal peaks
elsewhere); ccx2 against the oracle 2e-5 with the lag exact; normcorr and
normcorr_bank against the oracle and each other at the JAX tests' 2e-5 /
1e-6; subsample_shift exact against detex_tpu's on crafted peaks (edge,
flat, |tau| > 0.5, arccos argument outside [-1, 1], an all-zero row).
"""
import numpy as np
import pytest
import torch

from detex_tpu.ops import subsample as jsub
from detex_tpu.ops import xcorr as jx
from detex_torch.ops import subsample as tsub
from detex_torch.ops import xcorr as tx

NC = 3


def ccx2_oracle(mptd1, mptd2, nc):
    """float64 oracle of the reference _CCX2: (maxcc, lag, the
    channel-aligned truncated curve)."""
    n = len(mptd1)
    trunc = n // (2 * nc) - 1
    nfft = 2 ** int(2 * n).bit_length()
    x2 = np.asarray(mptd2, np.float64)
    c = np.fft.irfft(np.conj(np.fft.rfft(mptd1, nfft)) * np.fft.rfft(x2, nfft),
                     nfft)
    c1 = np.concatenate([c[-(n - 1):], c[:n]])
    padded = np.pad(x2, (n - 1, n - 1))
    cs = np.cumsum(np.insert(padded, 0, 0.0))
    cs2 = np.cumsum(np.insert(padded ** 2, 0, 0.0))
    a = (cs[n:] - cs[:-n]) / n
    b = np.sqrt(np.maximum((cs2[n:] - cs2[:-n]) / n - a * a, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        result = (c1 - np.sum(mptd1) * a) / (n * b * np.std(mptd1))
    result = result[nc - 1::nc][trunc:-trunc]
    result[(result > 1) | (result < -1)] = 0.0
    maxind = int(np.nanargmax(result))
    return result[maxind], (maxind + 1 + trunc) * nc - n, result


def peak_clear(curve, tol=1e-5):
    """True when the curve's maximum leads its runner-up by more than
    ``tol``."""
    top2 = np.sort(curve[np.isfinite(curve)])[-2:]
    return top2[1] - top2[0] > tol


def _events(rng, N, n, nc=NC):
    """N multiplexed events of n samples: three families sharing a
    waveform at random shifts plus noise, the rest pure noise."""
    L = -(-n // nc)
    X = rng.standard_normal((N, L * nc))
    for f in range(3):
        sig = np.hanning(L // 3) * rng.standard_normal(L // 3)
        for e in range(f, N, 4):
            at = rng.integers(0, L - len(sig))
            w = np.zeros((nc, L))
            w[:, at:at + len(sig)] = 8.0 * sig
            X[e] += w.flatten(order="F")
    return X[:, :n].astype(np.float32)


@pytest.mark.parametrize("n", [3000, 3001])
def test_xcorr_all_pairs_matches_jax(n):
    rng = np.random.default_rng(n)
    X = _events(rng, 12, n)
    got = tx.xcorr_all_pairs(X, NC, device="cpu")
    want = jx.xcorr_all_pairs(X, NC)
    iu = np.triu_indices(12, 1)
    lower = ~np.triu(np.ones((12, 12), bool), 1)
    assert np.isnan(got[0][lower]).all() and np.isnan(got[2][lower]).all()
    assert not got[1][lower].any()
    assert np.abs(got[0][iu] - want[0][iu]).max() <= 1e-5
    assert np.abs(got[2][iu] - want[2][iu]).max() <= 1e-4
    clear = 0
    for i, j in zip(*iu):
        occ, olag, curve = ccx2_oracle(X[i], X[j], NC)
        assert abs(got[0][i, j] - occ) <= 2e-5
        if peak_clear(curve):
            clear += 1
            assert got[1][i, j] == want[1][i, j] == olag, (i, j)
    assert clear >= 50


def test_xcorr_all_pairs_batches_and_degenerate_pairs():
    """Pairs split over several inverse transforms give the one-batch
    result, and an all-zero event gives (0, 0, 0) against every other."""
    rng = np.random.default_rng(5)
    X = _events(rng, 9, 600)
    X[4] = 0.0
    one = tx.xcorr_all_pairs(X, NC, device="cpu")
    many = tx.xcorr_all_pairs(X, NC, pair_batch=5, device="cpu")
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a, b)
    want = jx.xcorr_all_pairs(X, NC)
    for k in range(9):
        if k == 4:
            continue
        i, j = min(k, 4), max(k, 4)
        assert (one[0][i, j], one[1][i, j], one[2][i, j]) == (0, 0, 0)
        assert (want[0][i, j], want[1][i, j], want[2][i, j]) == (0, 0, 0)


@pytest.mark.parametrize("shift", [-40, 0, 37])
def test_ccx2_matches_oracle(shift):
    rng = np.random.default_rng(40 + shift)
    L = 1000
    base = np.zeros(L)
    base[200:600] = np.hanning(400) * rng.standard_normal(400)
    x1 = np.vstack([base + 0.05 * rng.standard_normal(L) for _ in range(NC)])
    x2 = np.vstack([np.roll(base, shift) + 0.05 * rng.standard_normal(L)
                    for _ in range(NC)])
    mp1, mp2 = x1.flatten(order="F"), x2.flatten(order="F")
    cc, lag, sub = tx.ccx2(mp1, mp2, NC, device="cpu")
    occ, olag, _ = ccx2_oracle(mp1, mp2, NC)
    assert abs(cc - occ) < 2e-5 and lag == olag == shift * NC
    jcc, jlag, jsb = jx.ccx2(mp1, mp2, NC)
    assert abs(cc - jcc) <= 1e-5 and abs(sub - jsb) <= 1e-4


def test_normcorr_matches_oracle_and_jax():
    rng = np.random.default_rng(8)
    t = rng.standard_normal(200)
    s = np.concatenate([rng.standard_normal(300), t * 2.5 + 0.1,
                        rng.standard_normal(300)])
    got = tx.normcorr(t, s, device="cpu")
    n = len(t)
    nt = (t - np.mean(t)) / (np.std(t) * n)
    cs = np.cumsum(np.insert(s, 0, 0.0))
    cs2 = np.cumsum(np.insert(s ** 2, 0, 0.0))
    a = (cs[n:] - cs[:-n]) / n
    b = np.sqrt((cs2[n:] - cs2[:-n]) / n - a * a)
    want = (np.convolve(nt[::-1], s, mode="valid") - nt.sum() * a) / b
    assert np.allclose(got, want, atol=2e-5)
    assert np.allclose(got, jx.normcorr(t, s), atol=2e-5)
    assert np.argmax(got) == 300 and got.max() > 0.999
    # the longer argument is the series, whichever order they come in
    np.testing.assert_array_equal(tx.normcorr(s, t, device="cpu"), got)


def test_normcorr_bank_matches_single():
    rng = np.random.default_rng(9)
    s = rng.standard_normal(2000)
    T = np.stack([s[100:400], s[500:800], rng.standard_normal(300)])
    bank = tx.normcorr_bank(T, s, device="cpu")
    for k in range(3):
        assert np.allclose(bank[k], tx.normcorr(T[k], s, device="cpu"),
                           atol=1e-6)
    assert np.allclose(bank, jx.normcorr_bank(T, s), atol=2e-5)
    assert np.argmax(bank[0]) == 100 and np.argmax(bank[1]) == 500


def test_subsample_shift_crafted_peaks():
    """Interior cosine peaks at sub-sample offsets, a peak on either edge,
    a flat top, an off-centre peak (|tau| > 0.5), an arccos argument
    outside [-1, 1] and an all-zero row: the port's batched shift equals
    detex_tpu's per-row shift, and the documented cases give 0."""
    x = np.arange(21, dtype=np.float64)
    rows, inds = [], []
    for tau in (-0.4, -0.1, 0.0, 0.25, 0.45):
        rows.append(np.cos(0.3 * (x - 10 - tau)))
        inds.append(10)
    rows.append(np.cos(0.3 * x))                 # peak on the first sample
    inds.append(0)
    rows.append(np.cos(0.3 * (x - 20)))          # on the last
    inds.append(20)
    rows.append(np.ones(21))                     # flat: arg == 1
    inds.append(10)
    rows.append(np.cos(0.3 * (x - 10.9)))        # argmax 11 forced to 10
    inds.append(10)
    rows.append(np.where(x == 10, 1.0, 0.9))     # arg 0.9, tau past 0.5?
    inds.append(10)
    rows.append(np.where(x == 10, 0.5, 1.0))     # a dip: arg 2 > 1
    inds.append(10)
    rows.append(np.zeros(21))
    inds.append(10)
    ceval = np.asarray(rows, np.float32)
    got = tsub.subsample_shift(torch.as_tensor(ceval),
                               torch.as_tensor(inds)).numpy()
    want = np.array([float(jsub.subsample_shift(r, i))
                     for r, i in zip(ceval, inds)])
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[:5], [-0.4, -0.1, 0.0, 0.25, 0.45],
                               atol=1e-3)
    assert (got[5:8] == 0).all() and (got[10:] == 0).all()
    assert got[8] == 0.0       # the true peak is 0.9 away: |tau| > 0.5
