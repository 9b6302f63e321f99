"""The detection engine's host helpers in detex_torch held against their
detex_tpu namesakes on the same inputs: the chunk preprocessing
(construct._applyFilter + multiplex on core.Stream), the float64 STA/LTA
(stalta.ds_stalta_np), the SNR's rolling standard deviation
(rolling.rolling_std) and the SQLite rows (util.saveSQLite /
loadSQLite).

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
from detex_torch import construct as tcons
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
