"""The detection engine's host helpers in detex_torch held against their
detex_tpu namesakes on the same inputs: the chunk preprocessing
(construct._applyFilter + multiplex on core.Stream), the float64 STA/LTA
(stalta.ds_stalta_np), the SNR's rolling standard deviation
(rolling.rolling_std) and the SQLite rows (util.saveSQLite /
loadSQLite). The batched engine's gate and histogram sums, and the
magnitudes, are held bit for bit against their row-by-row forms, kept
here as the reference.

Both packages filter with the native C++ library (each its own build of
native/detex_host.cpp) when it is built and with scipy otherwise. The
port's preprocessing is held bit for bit against detex_tpu's on either
path, and its native path within 1e-9 (relative to the trace's scale) of
the scipy one.
"""
import sqlite3

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct as jcons
from detex_tpu import native as jnative
from detex_tpu import util as jutil
from detex_tpu.core import Stream as JStream
from detex_tpu.core import Trace as JTrace
from detex_tpu.detect import SAR_COLS as JSAR_COLS
from detex_tpu.ops import stalta as jstalta
import torch

from detex_torch import construct as tcons
from detex_torch import detect as tdetect
from detex_torch import native as tnative
from detex_torch import util as tutil
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace
from detex_torch.detect import SAR_COLS
from detex_torch.ops import rolling as trolling
from detex_torch.ops import stalta as tstalta

SR = 40.0
T0 = 1238544000.0
CHANS = ("BHE", "BHN", "BHZ")


def _pieces(rng, case):
    """(channel, start offset in samples, data) of a 3-channel chunk:
    whole, fragmented (every channel cut by a gap, channels gapped at
    different places) or with a channel one sample short."""
    n = 20000
    out = []
    for c, ch in enumerate(CHANS):
        x = (rng.standard_normal(n) + 0.3 * np.sin(np.arange(n) / 50.0)
             + 1e-3 * np.arange(n) + 5.0 * c)
        if case in ("fragmented", "fragmented-fill"):
            g0 = 6000 + 1500 * c
            out.append((ch, 0, x[:g0]))
            out.append((ch, g0 + 200 + 10 * c, x[g0 + 200 + 10 * c:]))
        elif case == "short":
            out.append((ch, 0, x[:n - (c == 2)]))
        else:
            out.append((ch, 0, x))
    return out


def _streams(pieces):
    js, ts = JStream(), TStream()
    for ch, off, data in pieces:
        hdr = dict(network="TA", station="S01", location="", channel=ch,
                   sampling_rate=SR, starttime=T0 + off / SR)
        js.append(JTrace(data.copy(), dict(hdr)))
        ts.append(TTrace(data.copy(), dict(hdr)))
    return js, ts


# case -> (pieces, filt, decimate, dtype, fillZeros)
FILTER_CASES = {
    "plain": ("whole", [1, 8, 2, True], None, "double", False),
    "single": ("whole", [1, 8, 4, False], None, "single", False),
    "decimate": ("whole", [1, 5, 2, True], 2, "double", False),
    "merge-longest": ("fragmented", [1, 8, 2, True], None, "double", False),
    "merge-fill": ("fragmented-fill", [1, 8, 2, True], None, "double",
                   True),
    "short-channel": ("short", None, None, "double", False),
}


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_apply_filter_and_multiplex_match_jax(monkeypatch, case, native):
    """_applyFilter then multiplex on the same Stream: the same start time,
    sampling rate and multiplexed samples as detex_tpu's, identical with
    both packages on scipy and with both on their native libraries; the
    native path within 1e-9 of the scale of the scipy one."""
    pieces, filt, dec, dtype, fill = FILTER_CASES[case]

    def scipy_only():
        for lib in (jnative, tnative):
            monkeypatch.setattr(lib, "_TRIED", True)
            monkeypatch.setattr(lib, "_LIB", None)

    if not native:
        scipy_only()
    elif not (jnative.available() and tnative.available()):
        pytest.skip("the native library is not built here")
    js, ts = _streams(_pieces(np.random.default_rng(len(case)), pieces))
    jst = jcons._applyFilter(js, filt, dec, dtype, fillZeros=fill)
    tst = tcons._applyFilter(ts, filt, dec, dtype, fillZeros=fill)
    assert len(tst) == len(jst) == 3
    for a, b in zip(tst, jst):
        assert a.stats.channel == b.stats.channel
        assert a.stats.starttime.timestamp == b.stats.starttime.timestamp
        assert a.stats.sampling_rate == b.stats.sampling_rate
    got = tcons.multiplex(tst, 3)
    want = jcons.multiplex(jst, 3)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if native:
        scipy_only()
        _, ts = _streams(_pieces(np.random.default_rng(len(case)), pieces))
        sp = tcons.multiplex(tcons._applyFilter(ts, filt, dec, dtype,
                                                fillZeros=fill), 3)
        scale = np.abs(sp).max()
        assert np.abs(got.astype(np.float64) - sp).max() <= (
            1e-9 * scale if dtype == "double" else 1e-6 * scale)


@pytest.mark.parametrize("sta", [0, 1, 37])
def test_ds_stalta_np_matches_jax(sta):
    """The float64 STA/LTA of a DS row (NaN edges filled) against
    detex_tpu's, within 1e-12."""
    rng = np.random.default_rng(sta)
    c = np.abs(rng.standard_normal(5000)) * 0.1
    c[2000:2050] += 0.8
    got = tstalta.ds_stalta_np(c, 400.5, sta)
    want = jstalta.ds_stalta_np(c, 400.5, sta)
    assert got.dtype == np.float64 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-12


@pytest.mark.parametrize("n,win", [(6000, 750), (900, 750), (700, 750)])
def test_rolling_std_matches_native(n, win):
    """The SNR noise level's rolling sample std against detex_tpu's
    native.rolling_std (its C library when built), within 1e-9; empty
    when the row is shorter than the window."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 3.0 + 2.0
    got = trolling.rolling_std(x, win)
    want = jnative.rolling_std(x, win)
    assert got.shape == want.shape == (max(n - win + 1, 0),)
    if n >= win:
        assert np.abs(got - want).max() <= 1e-9


def _rows():
    rng = np.random.default_rng(3)
    rows = []
    for k in range(7):
        mag = np.nan if k % 3 == 0 else float(rng.uniform(0, 2))
        rows.append([np.float32(rng.uniform(0.3, 1)), 0.0 if k % 2 else 2.5,
                     T0 + 100.0 * k, str(k % 2), "TA.S0%d" % (k % 2),
                     T0 + 100.0 * k - 1.5, T0 + 100.0 * k - 0.5, mag,
                     np.float64(rng.uniform(1, 9)), mag])
    return rows


def test_sqlite_rows_match_jax(tmp_path):
    """The same detection rows written by the port's saveSQLite (row
    lists) and detex_tpu's (a DataFrame), appended in two calls: the same
    PRAGMA table_info and SELECT * (NaN as NULL); loadSQLite reads them
    back as detex_tpu's does."""
    assert SAR_COLS == JSAR_COLS
    rows = _rows()
    dbs = {"t": str(tmp_path / "t.db"), "j": str(tmp_path / "j.db")}
    for part in (rows[:4], rows[4:]):
        tutil.saveSQLite(part, dbs["t"], "ss_df", SAR_COLS)
        jutil.saveSQLite(pd.DataFrame(part, columns=JSAR_COLS), dbs["j"],
                         "ss_df")
    got = {}
    for k, path in dbs.items():
        con = sqlite3.connect(path)
        got[k] = (con.execute("PRAGMA table_info(ss_df)").fetchall(),
                  con.execute("SELECT * FROM ss_df").fetchall())
        con.close()
    assert got["t"][0] == got["j"][0]
    assert [c[2] for c in got["t"][0]] == ["REAL"] * 3 + ["TEXT"] * 2 + [
        "REAL"] * 5
    assert len(got["t"][1]) == 7
    assert repr(got["t"][1]) == repr(got["j"][1])
    cols = tutil.loadSQLite(dbs["t"], "ss_df", columns=True)
    want = jutil.loadSQLite(dbs["j"], "ss_df")
    assert list(cols) == list(want.columns)
    for c in SAR_COLS:
        w = want[c].to_numpy()
        if w.dtype.kind in "fi":
            np.testing.assert_array_equal(cols[c].astype(np.float64), w)
        else:
            assert list(cols[c]) == list(w)
    recs = tutil.loadSQLite(dbs["t"], "ss_df")
    assert len(recs) == 7 and recs[1]["Name"] == 1 and np.isnan(
        recs[0]["Mag"])
    assert tutil.loadSQLite(str(tmp_path / "none.db"), "ss_df") is None
    assert tutil.loadSQLite(dbs["t"], "sg_df") is None


# the gate: one station of five detectors (threshold 0.3 as in Case1, and
# others) over five chunks in batches of two, every scan's maxima made by
# hand at the float32 neighbours of threshold - margin
GATE_THR = [0.3, 0.1, 0.45, 0.3000001, 0.7]
GATE_MARGINS = {"single": ("single", False), "double": ("double", False),
                "devicePrep": ("single", True)}
GATE_SR, GATE_L, GATE_N, GATE_B = 25.0, 400, 5, 2


def _gate_maxima(rng, B, S_pad, n_real, eps):
    """[B, S_pad] float32 maxima: each real row of each real chunk one of
    the two float32 values below, at or two above float32(thr - eps), the
    first chunk's rows all below; pad rows and chunks 1.0."""
    m = np.ones((B, S_pad), np.float32)
    for si, thr in enumerate(GATE_THR):
        c = np.float32(thr - eps)
        nb = [np.nextafter(np.nextafter(c, np.float32(0)), np.float32(0)),
              np.nextafter(c, np.float32(0)), c,
              np.nextafter(c, np.float32(2)),
              np.nextafter(np.nextafter(c, np.float32(2)), np.float32(2))]
        m[:n_real, si] = rng.choice(nb, n_real)
    return m


@pytest.mark.parametrize("margin", sorted(GATE_MARGINS))
def test_gate_and_histograms_match_row_loop(monkeypatch, tmp_path, margin):
    """The batched engine's gate against the row-by-row comparison
    maxds[bi, si] > threshold[name] - gate_eps on the same maxima: the same
    (chunk, detector) pairs in the same order, each re-verified with its
    threshold as a Python float; the histograms the per-batch sums, name
    by name, as float64."""
    dtype, devicePrep = GATE_MARGINS[margin]
    gate_eps = max(tdetect.DEVICE_PREP_EPS if devicePrep else 0.0,
                   tdetect.GATE_EPS_DOUBLE if dtype == "double"
                   else tdetect.GATE_EPS_SINGLE)
    rng = np.random.default_rng(11)
    names = ["d%d" % k for k in range(len(GATE_THR))]
    dets = []
    for nm, thr in zip(names, GATE_THR):
        u = rng.standard_normal(60)
        U = (u / np.linalg.norm(u))[None]
        dets.append(dict(name=nm, U=U, WFs=3.0 * U, mags=[1.0],
                         events=["e"], offsets=[0.0], threshold=thr))
    X = rng.standard_normal((GATE_N, 3, GATE_L))
    scans, stacked, gated, thr_lists = [], [], [], []

    def chunks(sta):
        for b in range(GATE_N):
            yield TStream([TTrace(X[b, c].copy(), dict(
                network="XX", station="S1", channel=CHANS[c],
                sampling_rate=GATE_SR, starttime=T0 + 16.0 * b))
                for c in range(3)]), None, None

    def scan(X, *a, **kw):
        B, S_pad = X.shape[0], len(a[3] if devicePrep else a[1])
        n_real = sum(1 for L in (a[0] if devicePrep else kw["valid_lens"])
                     if L > 0)
        m = _gate_maxima(rng, B, S_pad, n_real, gate_eps)
        h = rng.integers(0, 50, (S_pad, 400)).astype(np.int32)
        scans.append((m, h))
        return torch.as_tensor(h), torch.as_tensor(m), None, None, None

    real_stack = tdetect._SSDetex._stackBatch

    def stack(self, batch, *a):
        stacked.append([c[2] for c in batch])
        return real_stack(self, batch, *a)

    def triggers(x_list, bank, nc, rows_list, thr_list, *a, **kw):
        thr_lists.append(thr_list)
        z = np.zeros(0, np.float32)
        return [{si: (np.zeros(0, np.int64), z, None) for si in rows}
                for rows in rows_list]

    def coeff_rows(self, idx, coefs, slvals, name, sta, det, MPcon, nc, sr,
                   tstamp):
        gated.append((tstamp, name))
        return []

    def host_rows(self, MPcon, name, threshold, sta, det, nc, sr, tstamp,
                  use_sl):
        gated.append((tstamp, name))
        return []

    monkeypatch.setattr(tdetect._pscan, "scan_chunks_raw" if devicePrep
                        else "scan_chunks", scan)
    monkeypatch.setattr(tdetect._SSDetex, "_stackBatch", stack)
    monkeypatch.setattr(tdetect._ds, "run_bank_triggers_batch", triggers)
    monkeypatch.setattr(tdetect._SSDetex, "_coeffRowList", coeff_rows)
    monkeypatch.setattr(tdetect._SSDetex, "_hostRows", host_rows)
    hist = tdetect.detex(
        {"XX.S1": dict(channels=list(CHANS), sr=GATE_SR, detectors=dets)},
        chunks, str(tmp_path / "g.db"), conDatDuration=14.0, conBuff=2.0,
        filt=[1, 8, 2, True], dtype=dtype, devicePrep=devicePrep,
        batchSize=GATE_B, device="cpu")

    # the row-by-row gate and histogram sums
    threshold = {d["name"]: float(d["threshold"]) for d in dets}
    assert len(scans) == len(stacked) == -(-GATE_N // GATE_B)
    want, want_thr = [], []
    want_hist = {nm: np.zeros(400) for nm in names}
    for (maxds, h), tstamps in zip(scans, stacked):
        trig_rows = []
        for bi in range(len(tstamps)):
            trig = [si for si, name in enumerate(names)
                    if maxds[bi, si] > threshold[name] - gate_eps]
            want += [(tstamps[bi], names[si]) for si in trig]
            if trig:
                trig_rows.append([threshold[names[si]] for si in trig])
        if trig_rows:
            want_thr.append(trig_rows)
        for si, name in enumerate(names):
            want_hist[name] = want_hist[name] + h[si]
    assert 0 < len(want) < len(names) * GATE_N
    assert gated == want
    if dtype == "single":
        assert thr_lists == want_thr
        assert all(type(t) is float for b in thr_lists for r in b for t in r)
    assert sorted(hist["XX.S1"]) == names
    for name in names:
        got = hist["XX.S1"][name]
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want_hist[name])


# the magnitudes: trigger sample -> a case; "early" lies within five
# template lengths of the chunk start (the SNR's noise after the trigger)
MAG_N, MAG_SR, MAG_LEN = 300, 25.0, 6000
MAG_CASES = {"late": (1200, False), "early": (100, False),
             "unusable": (1200, True)}


def _ref_estMag(issubspace, dtype, trigIndex, info, MPcon, nc):
    """_estMag with every term computed on the row: (peMag, stMag,
    SNR)."""
    WFU = info["WFU"]
    U = info["U"]
    ewf = info["WFs"]
    mags = info["mags"]
    WFlen = WFU.shape[1]
    ConDat = MPcon[trigIndex * nc: trigIndex * nc + WFlen]
    if len(ConDat) < WFlen:
        return np.nan, np.nan, np.nan
    if issubspace:
        ssCon = U.T @ (U @ ConDat)
        proEn = np.var(ssCon) / np.var(WFU, axis=1)
    if trigIndex * nc > 5 * WFlen:
        pe = MPcon[trigIndex * nc - 5 * WFlen: trigIndex * nc]
    else:
        pe = MPcon[trigIndex * nc: trigIndex * nc + WFlen + 6 * WFlen]
    rollingstd = tnative.rolling_std(pe, WFlen)
    baseNoise = np.median(rollingstd) if len(rollingstd) else np.nan
    SNR = np.std(ConDat) / baseNoise if baseNoise else np.nan
    touse = mags > -15
    if issubspace:
        if not np.any(touse):
            return np.nan, np.nan, SNR
        ftype = np.float64 if dtype == "double" else np.float32
        W = np.asarray(ewf, ftype)
        cd = np.asarray(ConDat, ftype)
        NT = (W - W.mean(axis=1, keepdims=True)) / \
            (W.std(axis=1, keepdims=True) * W.shape[1])
        eventCors = (NT @ cd - NT.sum(axis=1) * cd.mean()) / cd.std()
        w = np.square(np.asarray(eventCors))[touse]
        est = np.asarray(mags)[touse] + np.log10(np.sqrt(
            np.asarray(proEn)[touse]))
        peMag = float(np.sum(est * w) / np.sum(w))
        ratio = np.std(ConDat) / np.std(np.asarray(ewf), axis=1)[touse]
        est = np.asarray(mags)[touse] + np.log10(ratio)
        stMag = float(np.sum(est * w) / np.sum(w))
    else:
        if np.isnan(mags[0]) or mags[0] < -15:
            return np.nan, np.nan, SNR
        peMag = mags[0] + np.dot(ConDat, WFU[0]) / np.dot(WFU[0], WFU[0])
        stMag = mags[0] + np.log10(np.std(ConDat) / np.std(WFU[0]))
    return peMag, stMag, SNR


@pytest.mark.parametrize("case", sorted(MAG_CASES))
@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("issubspace", [True, False])
def test_est_mag_matches_row_expressions(issubspace, dtype, case):
    """_estMag on the detector terms _prepareDetectors builds once against
    every term computed on the row: the same values, bit for bit, and
    types; subspace and single detectors, float32 and float64 chunks, a
    detector with no magnitude above -15, and a trigger within five
    template lengths of the chunk start."""
    trig, unusable = MAG_CASES[case]
    rng = np.random.default_rng(7)
    D, E = (2, 4) if issubspace else (1, 1)
    U = np.linalg.qr(rng.standard_normal((MAG_N, D)))[0].T
    WFs = np.stack([U[0] * rng.uniform(2, 4) + U[-1] * rng.standard_normal()
                    + 0.1 * rng.standard_normal(MAG_N) for _ in range(E)])
    mags = ([-20.0, -30.0, -16.0, -15.5] if unusable
            else [1.0, 1.3, -20.0, 0.7])[:E]
    d = dict(name="d0", U=U, WFs=WFs, mags=mags, events=["e"] * E,
             offsets=[0.0] * E, threshold=0.3)
    eng = object.__new__(tdetect._SSDetex)
    eng.issubspace, eng.dtype, eng.devicePrep = issubspace, dtype, False
    eng.device, eng.dataLength = torch.device("cpu"), MAG_LEN / MAG_SR / 3
    info = eng._prepareDetectors([d], "XX.S1", list(CHANS), MAG_SR)[0]["d0"]
    x = rng.standard_normal(MAG_LEN)
    x[3 * trig:3 * trig + MAG_N] += 20.0 * U[0]
    MPcon = x.astype(np.float64 if dtype == "double" else np.float32)
    got = eng._estMag(trig, info, MPcon, 3, 0.5, T0, "d0", "XX.S1")
    want = _ref_estMag(issubspace, dtype, trig, info, MPcon, 3)
    assert [type(v) for v in got] == [type(v) for v in want]
    np.testing.assert_array_equal(np.asarray(got, np.float64),
                                  np.asarray(want, np.float64))
    assert np.isnan(got[0]) == unusable and np.isfinite(got[2])
