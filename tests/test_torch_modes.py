"""The engine's classify and UTC-save modes on the CPU: detex_torch's
SubSpace.detex(classifyEvents=..., utcSaves=...) against detex_tpu's on
the synthetic Case1 analog (the ``synth_case`` fixture of
tests/conftest.py, 25 Hz).

Both packages build their SubSpace from the same key files and
directories through their key-file entry points (createCluster ->
createSubSpace -> attachPickTimes -> SVD with a fixed threshold of 0.5, so
no FAS) at dtype "double"; each mode then runs at "double" and "single"
(the SubSpace's dtype set before the run). detex_tpu runs without its
device mesh (DETEX_TPU_MESH=0). Its tables are pickled DataFrames, read
with pandas and compared as ``df.to_dict("records")``; the port's are
lists of row dicts read with util.readRows. detex_tpu rounds batchSize up
(C31), which changes no row here (both modes run the per-chunk path), but
rows are compared sorted all the same.

Tolerances: the (Sta, Name, TimeStamp) keys of the classify rows
identical, TimeStamp, TS1 and TS2 exact, DS and SSdetect within 1e-6 at
"double" (both float64 on the host) and 2e-5 at "single" (float32 scans
of different bank forms, C30); MPcon bit for bit where both packages
build the native host library (C29), else within 1e-12 of its scale; the
detections both write in these modes equal in (Sta, Name, STMP) with DS
at the same tolerances. _conTrimSamps equal integer for integer at a
long and a short conBuff, and a short conBuff shortens each classified
DS vector by exactly int((duration - conBuff) * sr) samples.
"""
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct as jcon
from detex_tpu import detect as jdetect
from detex_tpu import native as jnative
from detex_tpu import util as jutil
from detex_tpu.data import fetcher as jget
import detex_torch
from detex_torch import detect as tdetect
from detex_torch import native as tnative
from detex_torch import util as tutil
from detex_torch.data import fetcher as tget

TOL = {"double": 1e-6, "single": 2e-5}


@pytest.fixture(scope="module")
def both(synth_case, tmp_path_factory):
    """detex_tpu's and detex_torch's SubSpace from the same key files."""
    wd = tmp_path_factory.mktemp("tmodes")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        out = {}
        for pkg, con, get, kw in (
                ("j", jcon, jget, {}),
                ("t", detex_torch, tget, dict(device="cpu"))):
            clust = con.createCluster(
                CCreq=0.5, fetch_arg=synth_case["eventDir"],
                filt=[1, 8, 2, True], stationKey=synth_case["stationKey"],
                templateKey=synth_case["templateKey"], trim=[10, 60],
                saveclust=False, dtype="double", **kw)
            cf = get.DataFetcher("dir", directoryName=synth_case["conDir"])
            ss = con.createSubSpace(Pf=1e-9, clust=clust, conDatFetcher=cf,
                                    **kw)
            ss.attachPickTimes(pksFile=synth_case["phaseKey"],
                               defaultDuration=20)
            ss.SVD(selectCriteria=2, selectValue=0.9, threshold=0.5,
                   useSingles=True)
            out[pkg] = ss
    finally:
        os.chdir(cwd)
    return out


def _run(ss, dtype, **kw):
    saved = ss.dtype
    ss.dtype = dtype
    try:
        ss.detex(subspaceDB="modes.db", estimateMags=False,
                 useSingles=False, **kw)
    finally:
        ss.dtype = saved


def _modes(both, synth_case, tmp_path, monkeypatch, dtype, **kw):
    """Run the same mode in both packages, each in a directory of its
    own; returns (port dir, detex_tpu dir)."""
    monkeypatch.setenv("DETEX_TPU_MESH", "0")
    dirs = []
    for pkg in ("t", "j"):
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.chdir(d)
        _run(both[pkg], dtype, **kw)
        dirs.append(str(d))
    return dirs


def _key(r):
    return (r["Sta"], r["Name"], r["TimeStamp"])


def _sqlite_rows_match(dt, dj, tol):
    got = sorted(tutil.loadSQLite(os.path.join(dt, "modes.db"), "ss_df"),
                 key=lambda r: (r["Sta"], r["Name"], r["STMP"]))
    want = sorted(jutil.loadSQLite(os.path.join(dj, "modes.db"),
                                   "ss_df").to_dict("records"),
                  key=lambda r: (r["Sta"], r["Name"], r["STMP"]))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["Sta"], g["Name"], g["STMP"]) == \
            (w["Sta"], w["Name"], w["STMP"])
        assert abs(g["DS"] - w["DS"]) <= tol


@pytest.mark.parametrize("dtype", ["double", "single"])
def test_classify_matches_jax(both, synth_case, tmp_path, monkeypatch,
                              dtype):
    dt, dj = _modes(both, synth_case, tmp_path, monkeypatch, dtype,
                    classifyEvents=synth_case["templateKey"])
    files = sorted(f for f in os.listdir(dj) if f.startswith("EventCors"))
    assert files == sorted(f for f in os.listdir(dt)
                           if f.startswith("EventCors"))
    assert files == ["EventCors_TA.S00.pkl", "EventCors_TA.S01.pkl"]
    n_events = len(pd.read_csv(synth_case["templateKey"]))
    for f in files:
        got = tutil.readRows(os.path.join(dt, f))
        want = pd.read_pickle(os.path.join(dj, f))
        assert [list(r) for r in got] == [list(want.columns)] * len(got)
        want = sorted(want.to_dict("records"), key=_key)
        got = sorted(got, key=_key)
        assert [_key(r) for r in got] == [_key(r) for r in want]
        assert len(got) == n_events * len(both["t"].subspaces[
            got[0]["Sta"]])
        err = max(abs(g["DS"] - w["DS"]) for g, w in zip(got, want))
        assert err <= TOL[dtype]
        # the training events on their own subspace
        assert max(r["DS"] for r in got) > 0.8
    _sqlite_rows_match(dt, dj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["double", "single"])
def test_utc_saves_match_jax(both, synth_case, tmp_path, monkeypatch,
                             dtype):
    times = [e["time"] for e in synth_case["cat"].hidden]
    dt, dj = _modes(both, synth_case, tmp_path, monkeypatch, dtype,
                    utcSaves=times)
    got = tutil.readRows(os.path.join(dt, "UTCsaves.pkl"))
    want = pd.read_pickle(os.path.join(dj, "UTCsaves.pkl"))
    assert [list(r) for r in got] == [list(want.columns)] * len(got)
    order = ("Station", "Name", "TS1")
    want = sorted(want.to_dict("records"),
                  key=lambda r: tuple(r[c] for c in order))
    got = sorted(got, key=lambda r: tuple(r[c] for c in order))
    assert [tuple(r[c] for c in order) for r in got] == \
        [tuple(r[c] for c in order) for r in want]
    assert len(got) >= len(times)
    exact_mp = tnative.available() and jnative.available()
    for g, w in zip(got, want):
        assert g["TS2"] == w["TS2"] and g["Threshold"] == w["Threshold"]
        assert list(g["offset"]) == list(w["offset"])
        np.testing.assert_array_equal(g["utcSaves"], w["utcSaves"])
        assert g["TS1"] < g["utcSaves"].min() <= g["utcSaves"].max() < \
            g["TS2"]
        assert g["MPcon"].shape == w["MPcon"].shape
        if exact_mp:
            np.testing.assert_array_equal(g["MPcon"], w["MPcon"])
        else:
            scale = np.abs(w["MPcon"]).max()
            assert np.abs(g["MPcon"] - w["MPcon"]).max() <= 1e-12 * scale
        assert g["SSdetect"].shape == w["SSdetect"].shape
        assert np.abs(g["SSdetect"] - w["SSdetect"]).max() <= TOL[dtype]
    _sqlite_rows_match(dt, dj, TOL[dtype])


def _trims(both, sta, buff):
    """_conTrimSamps of both engines on one station's subspaces."""
    jobj = object.__new__(jdetect._SSDetex)
    jobj.classifyEvents = "key"
    jobj.fetcher = SimpleNamespace(conBuff=buff)
    tobj = object.__new__(tdetect._SSDetex)
    tobj.classify = True
    tobj.conBuff = buff
    dets = both["t"]._stations(True)[sta]["detectors"]
    df = both["j"].subspaces[sta]
    nc = len(next(iter(df.iloc[0].Channels.values())))
    sr = df.iloc[0].Stats[df.iloc[0].Events[0]]["sampling_rate"]
    return (tobj._conTrimSamps(dets, nc, sr),
            jobj._conTrimSamps(df, nc, sr))


@pytest.mark.parametrize("buff", [1000.0, 5.0])
def test_con_trim_samps_match_jax(both, buff):
    for sta in both["j"].ssStations:
        got, want = _trims(both, sta, buff)
        assert got == want and isinstance(got, int)
        assert (got > 0) == (buff < 20.0)


def test_classify_conbuff_trim(both, synth_case, tmp_path, monkeypatch):
    """With a conBuff shorter than the templates, each classified chunk
    loses (duration - conBuff) s at its end: seen in the length of the
    UTC-saved DS vector, in both packages."""
    cat = synth_case["cat"]
    t = cat.events[0]["time"] + 3  # inside the first event's chunk
    sr = cat.sr
    row0 = next(iter(both["t"].subspaces.values()))[0]
    nc = len(next(iter(row0["Channels"].values())))
    dur = (row0["SampleTrims"]["Endtime"] -
           row0["SampleTrims"]["Starttime"]) / (sr * nc)
    assert dur >= 20.0
    lens = {}
    for buff in (1000.0, 5.0):
        fets = [both[p].clusters.fetcher for p in ("t", "j")]
        old = [f.conBuff for f in fets]
        for f in fets:
            f.conBuff = buff
        (tmp_path / str(buff)).mkdir()
        try:
            dt, dj = _modes(both, synth_case, tmp_path / str(buff),
                            monkeypatch, "double",
                            classifyEvents=synth_case["templateKey"],
                            utcSaves=[t])
        finally:
            for f, o in zip(fets, old):
                f.conBuff = o
        got = sorted(tutil.readRows(os.path.join(dt, "UTCsaves.pkl")),
                     key=lambda r: (r["Station"], r["Name"]))
        want = pd.read_pickle(os.path.join(dj, "UTCsaves.pkl")).sort_values(
            ["Station", "Name"]).reset_index(drop=True)
        assert [len(r["SSdetect"]) for r in got] == \
            [len(x) for x in want.SSdetect]
        lens[buff] = len(got[0]["SSdetect"])
    assert lens[1000.0] - lens[5.0] == int((dur - 5.0) * sr)
