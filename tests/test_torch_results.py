"""detex_torch's results (detResults, SSResults.writeDetections) and
util.loadSQLite(sql=...) on the CPU against detex_tpu's.

Both packages' detResults read the same SubSpace.db, written by detex_tpu's
saveSQLite: seeded detection rows of three stations around the template
events of the ``synth_case`` fixture (tests/conftest.py), its hidden
events and other times, with ties in DS inside a station's overlap groups
(the group keeps the last of its lexsort order), ties in MSTAMPmin across
stations (numpy's non-stable quicksort of more than 16 rows decides their
order), NaN magnitudes and STA/LTA values, and detector info whose beta
parameters send one threshold through the grid search of
_approximateThreshold. Dets, Autos and Vers must come out equal: the same
rows in the same order, every value equal (NaN to NaN), each event's
detection rows equal. Cases cover the associate buffers, requiredNumStations
with a float and a per-station exceptionalThreshold, Pf, a station list
with a time window, trigCon 1, reduceDets off, a veriFile in SQLite and
includeAllVeriColumns off. writeDetections writes the same waveform files
and a byte-identical new template key.
"""
import filecmp
import os
import sqlite3

import numpy as np
import pandas as pd
import pytest

from detex_tpu import native as jnative
from detex_tpu import results as jres
from detex_tpu import util as jutil
from detex_tpu.core.utc import UTCDateTime as JUTC
from detex_torch import native as tnative
from detex_torch import results as tres
from detex_torch import util as tutil

STATIONS = ["TA.S00", "TA.S01", "TA.S02"]
COLS = ["DS", "DS_STALTA", "STMP", "Name", "Sta", "MSTAMPmin", "MSTAMPmax",
        "Mag", "SNR", "ProEnMag"]


def _rows(rng, times, names):
    """Detection rows around each time: per station (most of the time)
    one to three rows of one detector 0.04 s apart on a 0.04 s grid, so
    that equal times recur; some DS repeat inside a group."""
    rows = []
    for t in times:
        for sta in STATIONS:
            if rng.random() < 0.25:
                continue
            name = names[int(rng.integers(len(names)))]
            base = round((t + rng.uniform(2, 6)) / 0.04) * 0.04
            ds = np.round(rng.uniform(0.2, 0.9, int(rng.integers(1, 4))), 3)
            if len(ds) > 1 and rng.random() < 0.5:
                ds[-1] = ds[0]                    # a DS tie in the group
            for k, d in enumerate(ds):
                stmp = base + 0.04 * k
                off = [3.5, 4.0] if name.startswith("SS") else [3.7, 3.7]
                rows.append(dict(
                    DS=float(d), DS_STALTA=(np.nan if rng.random() < 0.2
                                            else float(rng.uniform(2, 9))),
                    STMP=stmp, Name=name, Sta=sta, MSTAMPmin=stmp - off[1],
                    MSTAMPmax=stmp - off[0],
                    Mag=np.nan if rng.random() < 0.15 else
                    float(np.round(rng.uniform(0.5, 2.0), 2)),
                    SNR=float(rng.uniform(1, 20)),
                    ProEnMag=np.nan if rng.random() < 0.3 else
                    float(np.round(rng.uniform(0.5, 2.0), 2))))
    return rows


@pytest.fixture(scope="module")
def db(synth_case, tmp_path_factory):
    """The shared SubSpace.db and veriFiles (csv and SQLite)."""
    wd = tmp_path_factory.mktemp("tresults")
    rng = np.random.default_rng(21)
    tem = pd.read_csv(synth_case["templateKey"])
    ver = pd.read_csv(synth_case["veriFile"])
    t0 = JUTC("2009-04-01T00-00-00").timestamp
    times = ([JUTC(x).timestamp for x in tem.TIME] +
             [JUTC(x).timestamp for x in ver.TIME] +
             list(t0 + np.sort(rng.uniform(0, 19 * 3600, 24))))
    ss = _rows(rng, times, ["SS0", "SS1"])
    sg = _rows(rng, times, ["SG0"])
    # the same start time on two stations, more than 16 rows into the sort
    for a, b in ((ss[20], ss[21]), (ss[40], sg[10])):
        b["MSTAMPmin"], b["MSTAMPmax"] = a["MSTAMPmin"], a["MSTAMPmax"]
    path = str(wd / "SubSpace.db")
    jutil.saveSQLite(pd.DataFrame(ss, columns=COLS), path, "ss_df")
    jutil.saveSQLite(pd.DataFrame(sg, columns=COLS), path, "sg_df")
    info = [dict(Name=n, Sta=s, Events="a,b,c", Threshold=0.3,
                 NumBasisUsed=2, beta1=b1, beta2=b2)
            for s in STATIONS for n, b1, b2 in
            (("SS0", 3.1, 80.0), ("SS1", 40.0, 6.0))]
    jutil.saveSQLite(pd.DataFrame(info), path, "ss_info")
    jutil.saveSQLite(pd.DataFrame(
        [dict(Name="SG0", Sta=s, Events="a", Threshold=0.35, beta1=2.5,
              beta2=60.0) for s in STATIONS]), path, "sg_info")
    jutil.saveSQLite(pd.DataFrame([dict(FREQMIN=1, FREQMAX=8, CORNERS=2,
                                        ZEROPHASE=1)]), path, "filt_params")
    extra = pd.DataFrame(dict(
        TIME=[str(JUTC(t)).split(".")[0].replace(":", "-")
              for t in list(times[-6:]) + [t0 + 19.5 * 3600]],
        NAME=["X%d" % k for k in range(7)], LAT=40.1, LON=-111.0,
        MAG=1.0, DEPTH=4.0, AGENCY="UU"))
    veri = pd.concat([ver, extra], ignore_index=True)
    vcsv = str(wd / "veri.csv")
    veri.to_csv(vcsv, index=False)
    vdb = str(wd / "veri.db")
    jutil.saveSQLite(veri, vdb, "verify")
    return dict(path=path, veri=vcsv, veridb=vdb, wd=wd, **synth_case)


CASES = {
    "default": dict(requiredNumStations=2, veriBuffer=4),
    "buffers": dict(requiredNumStations=2, ss_associateBuffer=3,
                    sg_associateBuffer=6, veriBuffer=10),
    "exceptional-float": dict(requiredNumStations=3,
                              exceptionalThreshold=0.6),
    "exceptional-dict": dict(requiredNumStations=3, exceptionalThreshold={
        "TA.S00": 0.5, "TA.S01": 0.7}),
    "pf": dict(requiredNumStations=2, Pf=1e-6),
    "stations-window": dict(requiredNumStations=2,
                            stations=["TA.S00", "TA.S01"],
                            starttime="2009-04-01T02-00-00",
                            endtime="2009-04-01T15-00-00"),
    "trigcon1": dict(requiredNumStations=2, trigCon=1, trigParameter=4),
    "no-reduce": dict(requiredNumStations=2, reduceDets=False),
    "veri-sqlite": dict(requiredNumStations=1, veriFile="veridb"),
    "veri-columns-off": dict(requiredNumStations=1,
                             includeAllVeriColumns=False),
}


def _eq(g, w):
    if isinstance(w, float) and np.isnan(w):
        return isinstance(g, float) and np.isnan(g)
    return g == w


def _same_table(got, want, columns_in_order=True):
    """Row dicts ``got`` equal to DataFrame ``want``: rows in order, every
    value, each event's detection rows."""
    assert len(got) == len(want)
    for g, (_, w) in zip(got, want.iterrows()):
        if columns_in_order:
            assert list(g) == list(want.columns)
        assert set(g) == set(want.columns)
        for c in want.columns:
            if c == "Dets":
                _same_table(g[c], w[c])
            else:
                assert _eq(g[c], w[c]), (c, g[c], w[c])


def _both(db, case):
    kw = dict(CASES[case])
    veri = db[kw.pop("veriFile", "veri")]
    common = dict(ssDB=db["path"], templateKey=db["templateKey"],
                  stationKey=db["stationKey"], veriFile=veri,
                  fetch=db["conDir"])
    return (tres.detResults(**common, **kw), jres.detResults(**common, **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_det_results_match_jax(db, case):
    got, want = _both(db, case)
    assert len(want.Dets) > 0 and len(want.Autos) > 0
    _same_table(got.Dets, want.Dets)
    _same_table(got.Autos, want.Autos)
    assert isinstance(want.Vers, pd.DataFrame) and len(want.Vers) > 0
    _same_table(got.Vers, want.Vers, columns_in_order=False)
    assert [c for c in got.Vers[0] if c.startswith("Ver")] == \
        [c for c in want.Vers.columns if c.startswith("Ver")]
    assert got.NumVerified == want.NumVerified
    assert repr(got) == repr(want)


def test_ties_decide_the_kept_rows(db):
    """The crafted ties matter: the rows kept per overlap group and the
    association order follow the sorts, so a stable single-column sort
    would not give detex_tpu's rows."""
    rows = tutil.loadSQLite(db["path"], "ss_df")
    times = np.array([r["MSTAMPmin"] for r in rows])
    assert len(times) - len(np.unique(times)) >= 2
    stable = np.argsort(times, kind="stable")
    assert not np.array_equal(np.argsort(times, kind="quicksort"), stable)
    dups = tres._deleteDetDups(db["path"], 0, 0, 1, None, None, None,
                               "ss_df")
    assert [r["Gnum"] for r in dups] == sorted(r["Gnum"] for r in dups)
    want = jres._deleteDetDups(db["path"], 0, 0, 1, None, None, None,
                               "ss_df")
    _same_table(dups, want)


def test_approximate_threshold_and_pf_key(db):
    """The Pf key of both packages, one detector past 0.94 through
    _approximateThreshold."""
    got = tres._makePfKey(*tres._loadInfoDataFrames(db["path"]), 1e-6)
    want = jres._makePfKey(*jres._loadInfoDataFrames(db["path"]), 1e-6)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for gr, (_, wr) in zip(g, w.iterrows()):
            assert (gr["Sta"], gr["Name"], gr["DS"]) == \
                (wr.Sta, wr.Name, wr.DS)
    assert any(r["DS"] > 0.94 for r in got[0])
    assert tres._approximateThreshold(40.0, 6.0, 1e-6, 1000, 3) == \
        jres._approximateThreshold(40.0, 6.0, 1e-6, 1000, 3)


def test_pickled_veri_file_raises(db, tmp_path):
    path = str(tmp_path / "veri.pkl")
    pd.read_csv(db["veri"]).to_pickle(path)
    with pytest.raises(NotImplementedError, match="pandas"):
        tres._readVeriFile(path)


def test_load_sqlite_sql_option(db):
    """loadSQLite's sql, convertNumeric and silent options against
    detex_tpu's: the selected rows and values, numbers left as stored
    without convertNumeric, None for a missing table or a failing query."""
    sql = ('SELECT * FROM ss_df WHERE Sta="TA.S01" AND DS >= 0.5 AND '
           'MSTAMPmin>=0.000000')
    got = tutil.loadSQLite(db["path"], "ss_df", sql=sql)
    want = jutil.loadSQLite(db["path"], "ss_df", sql=sql)
    _same_table(got, want)
    assert 0 < len(got) < len(tutil.loadSQLite(db["path"], "ss_df"))
    con = sqlite3.connect(db["path"])
    con.execute('CREATE TABLE t (a TEXT, b TEXT)')
    con.executemany('INSERT INTO t VALUES (?, ?)',
                    [("1", "x"), ("2.5", None), ("007", "y")])
    con.commit()
    con.close()
    for conv in (True, False):
        _same_table(tutil.loadSQLite(db["path"], "t", convertNumeric=conv),
                    jutil.loadSQLite(db["path"], "t", convertNumeric=conv))
    assert [r["a"] for r in tutil.loadSQLite(db["path"], "t")] == \
        [1.0, 2.5, 7.0]
    assert tutil.loadSQLite(db["path"], "nope") is None
    assert tutil.loadSQLite(db["path"], "nope", silent=False) is None
    assert tutil.loadSQLite(db["path"], "t", sql="SELEC oops") is None
    assert tutil.loadSQLite(str(db["wd"] / "no.db"), "t") is None


def test_write_detections_match_jax(db, monkeypatch):
    """writeDetections of both packages (their getStream on scipy's
    detrend, both native libraries off): the same waveform files, array
    for array, and a byte-identical new template key; every station of the
    station key written for every new detection."""
    for lib in (jnative, tnative):
        monkeypatch.setattr(lib, "_TRIED", True)
        monkeypatch.setattr(lib, "_LIB", None)
    got, want = _both(db, "default")
    out = {}
    for tag, res in (("t", got), ("j", want)):
        ev = str(db["wd"] / ("events_" + tag))
        key = str(db["wd"] / ("key_%s.csv" % tag))
        written = res.writeDetections(eventDir=ev, temkeyPath=key,
                                      timeBeforeOrigin=20,
                                      timeAfterOrigin=40)
        out[tag] = (ev, key, written)
    ev_t, key_t, written = out["t"]
    ev_j, key_j, _ = out["j"]
    assert filecmp.cmp(key_t, key_j, shallow=False)
    assert len(written) == 2 * len(got.Dets) > 0
    for path in written:
        rel = os.path.relpath(path, ev_t)
        with np.load(path) as a, np.load(os.path.join(ev_j, rel)) as b:
            assert sorted(a.files) == sorted(b.files)
            for x in a.files:
                np.testing.assert_array_equal(a[x], b[x])
    assert sorted(os.path.relpath(os.path.join(d, f), ev_j)
                  for d, _, fs in os.walk(ev_j) for f in fs) == \
        sorted(os.path.relpath(p, ev_t) for p in written)
