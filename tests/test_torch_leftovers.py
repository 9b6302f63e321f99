"""The small pieces of detex_torch held against their detex_tpu namesakes
on the CPU: ops/ds.ds_single, ops/rolling.rolling_sum,
core/filters.highpass and demean, core/stream.Stream.max and
ops/xcorr.xcorr_all_pairs' ``nfft`` and ``dtype``; and the log file
(detex_torch.setLogger -> log -> closeLogger -> util.readLog).

Tolerances, the JAX tests' own: ds_single within 2e-5 of the float64
oracle ds_numpy and of detex_tpu's; rolling_sum within 5e-5 of the
float64 window sums and of detex_tpu's; highpass, demean and Stream.max
exact (both packages run scipy and numpy in float64); xcorr_all_pairs at
a given nfft cc 1e-5 and subsample 1e-4 against detex_tpu's, lags exact
where the float64 oracle's peak is clear, and at float64 against that
oracle within 1e-9 with every lag exact. readLog's rows equal detex_tpu's
readLog of the same file.
"""
import logging
import os

import numpy as np
import pytest
import torch

import detex_torch
from detex_tpu import util as jutil
from detex_tpu.core import filters as jfilt
from detex_tpu.core.stream import Stream as JStream
from detex_tpu.core.stream import Trace as JTrace
from detex_tpu.ops import ds as jds
from detex_tpu.ops import rolling as jroll
from detex_tpu.ops import xcorr as jx
from detex_torch import util as tutil
from detex_torch.core import filters as tfilt
from detex_torch.core.stream import Stream, Trace
from detex_torch.ops import ds as tds
from detex_torch.ops import rolling as troll
from detex_torch.ops import xcorr as tx
from test_torch_xcorr import _events, ccx2_oracle, peak_clear

NC = 3


def _ds_single(rng):
    n_c, L_c = 200, 4000
    n = n_c * NC
    U = np.linalg.qr(rng.standard_normal((n, 2)))[0].T
    x = 0.3 * rng.standard_normal(L_c * NC)
    x[1500 * NC:1500 * NC + n] += 3.0 * U[0]
    nfft = tds.required_fft_len(len(x), n)
    Ufd = tds.prep_basis_fd(U, nfft)
    got = tds.ds_single(torch.as_tensor(x, dtype=torch.float32),
                        torch.as_tensor(Ufd.astype(np.complex64)),
                        torch.as_tensor(U.sum(axis=1), dtype=torch.float32),
                        n, NC, nfft).numpy()
    want = np.asarray(jds.ds_single(
        np.float32(x), jds.prep_basis_fd(U, nfft), np.float32(U.sum(axis=1)),
        n, NC, nfft))
    oracle = tds.ds_numpy(x, U, NC)
    assert got.shape == want.shape == oracle.shape
    assert np.abs(got - oracle).max() < 2e-5
    assert np.abs(got - want).max() < 2e-5
    assert int(np.argmax(got)) == 1500


def _rolling_sum(rng):
    for n, L in ((3, 257), (300, 7777)):
        x = rng.standard_normal(L).astype(np.float32)
        got = troll.rolling_sum(torch.as_tensor(x), n)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        oracle = np.convolve(x.astype(np.float64), np.ones(n), "valid")
        want = np.asarray(jroll.rolling_sum(x, n))
        assert np.abs(got.numpy() - oracle).max() < 5e-5
        assert np.abs(got.numpy() - want).max() < 5e-5
        assert np.array_equal(troll.rolling_sum(x, n).numpy(), got.numpy())


def _filters(rng):
    x = rng.standard_normal(3000)
    for kw in (dict(corners=2, zerophase=True), dict(corners=4)):
        np.testing.assert_array_equal(tfilt.highpass(x, 2.0, 25.0, **kw),
                                      jfilt.highpass(x, 2.0, 25.0, **kw))
    np.testing.assert_array_equal(tfilt.demean(x + 5.0),
                                  jfilt.demean(x + 5.0))
    assert abs(tfilt.demean(x + 5.0).mean()) < 1e-12


def _stream_max(rng):
    datas = [rng.standard_normal(50) * 3, np.array([]),
             np.r_[rng.standard_normal(20), np.nan, -9.5]]
    got = Stream([Trace(d.copy(), dict(channel="BH%d" % i))
                  for i, d in enumerate(datas)]).max()
    want = JStream([JTrace(d.copy(), dict(channel="BH%d" % i))
                    for i, d in enumerate(datas)]).max()
    assert got == want and got[1] == 0.0 and got[2] == 9.5


def _xcorr_nfft_dtype(rng):
    N = 8
    X = _events(rng, N, 3001)
    iu = np.triu_indices(N, 1)
    got = tx.xcorr_all_pairs(X, NC, nfft=16384, device="cpu")
    want = jx.xcorr_all_pairs(X, NC, nfft=16384)
    np.testing.assert_allclose(got[0][iu], want[0][iu], atol=1e-5)
    np.testing.assert_allclose(got[2][iu], want[2][iu], atol=1e-4)
    exact = 0
    for i, j in zip(*iu):
        cc, lag, curve = ccx2_oracle(X[i], X[j], NC)
        if peak_clear(curve):
            assert got[1][i, j] == want[1][i, j] == lag
            exact += 1
    assert exact >= len(iu[0]) // 2
    # the polyphase path transforms at its own length whatever nfft is
    Xp = X[:, :3000]
    a = tx.xcorr_all_pairs(Xp, NC, nfft=16384, device="cpu")
    b = tx.xcorr_all_pairs(Xp, NC, device="cpu")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    for Y in (X, Xp):     # float64 on both paths, against the oracle
        cc64, lag64, _ = tx.xcorr_all_pairs(Y, NC, dtype=torch.float64,
                                            device="cpu")
        for i, j in zip(*iu):
            cc, lag, _ = ccx2_oracle(Y[i].astype(np.float64), Y[j], NC)
            assert abs(cc64[i, j] - cc) <= 1e-9 and lag64[i, j] == lag
    one = tx.ccx2(X[0], X[4], NC, nfft=16384, dtype=torch.float64,
                  device="cpu")
    assert abs(one[0] - ccx2_oracle(X[0].astype(np.float64), X[4],
                                    NC)[0]) <= 1e-9


CASES = {"ds_single": _ds_single, "rolling_sum": _rolling_sum,
         "highpass_demean": _filters, "stream_max": _stream_max,
         "xcorr_nfft_dtype": _xcorr_nfft_dtype}


@pytest.mark.parametrize("case", sorted(CASES))
def test_leftover_matches_jax(case):
    CASES[case](np.random.default_rng(sorted(CASES).index(case)))


def test_log_file_round_trip_and_size_cap(tmp_path):
    path = str(tmp_path / "detex_torch.log")
    try:
        logger = detex_torch.setLogger(path)
        assert logger.propagate is False
        detex_torch.log("mod.one", "first message")
        detex_torch.log("mod.two", "a\ttabbed warning", level="warning")
        with pytest.raises(ValueError):
            detex_torch.log("mod.three", "gone wrong", level="error",
                            e=ValueError)
    finally:
        detex_torch.closeLogger()
    logger = logging.getLogger("detex_torch")
    assert not logger.handlers and logger.propagate
    detex_torch.log("mod.four", "not in the file")
    rows = tutil.readLog(path)
    assert [(r["Mod"], r["Level"], r["Msg"]) for r in rows] == [
        ("detex_torch", "INFO", "mod.one: first message"),
        ("detex_torch", "WARNING", "mod.two: a\ttabbed warning"),
        ("detex_torch", "ERROR", "mod.three: gone wrong")]
    assert rows == jutil.readLog(path).to_dict("records")
    # appended below the cap, started again above it or with deleteOld
    for big, delete, kept in ((False, False, 4), (True, False, 1),
                              (False, True, 1)):
        if big:
            with open(path, "a") as fh:
                fh.write("x" * (10 * 1024 * 1024 + 1))
        try:
            detex_torch.setLogger(path, deleteOld=delete)
            detex_torch.log("mod.five", "again")
        finally:
            detex_torch.closeLogger()
        assert len(tutil.readLog(path)) == kept
        assert os.path.getsize(path) < 10 * 1024 * 1024
