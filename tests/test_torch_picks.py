"""Trims and phase picks of detex_torch on the CPU against detex_tpu's:
SubSpace.autoPickTimes and pickTimes (with a scripted picker, and
stopped after the first group), util.pickPhases (scripted and stopped)
and autoPickPhases with the file each writes, attachPickTimes on both
files, and streamPick's headless contract (ported from
tests/test_streampick.py).

Both packages build from the ``synth_case`` key files (tests/conftest.py)
at dtype "double": createCluster once a package, a fresh createSubSpace
for each test. A scripted picker picks P at a fixed sample of the first
trace and Pend 200 samples later, in each package's own Pick and
UTCDateTime types.

Tolerances: SampleTrims equal (every key, integers exact); Stats start
times and offsets within 1e-9 s and Offsets, where detex_tpu has set
them, within 1e-9; pick files compared row by row as pandas reads them,
TimeStamp within 1e-6 s and every other column exact (the port writes
its files without pandas).
"""
import os

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct as jcon
from detex_tpu import streamPick as jpick
from detex_tpu import util as jutil
from detex_tpu.data import fetcher as jget
import detex_torch
from detex_torch import streamPick as tpick
from detex_torch import util as tutil
from detex_torch.core.stream import Stream, Trace
from detex_torch.data import fetcher as tget

PKGS = {"j": (jcon, jget, jpick, jutil, {}),
        "t": (detex_torch, tget, tpick, tutil, dict(device="cpu"))}


@pytest.fixture(scope="module")
def clusters(synth_case, tmp_path_factory):
    """Each package's ClusterStream from the same key files."""
    wd = tmp_path_factory.mktemp("tpicks")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        return {p: con.createCluster(
            CCreq=0.5, fetch_arg=synth_case["eventDir"],
            filt=[1, 8, 2, True], stationKey=synth_case["stationKey"],
            templateKey=synth_case["templateKey"], trim=[10, 60],
            saveclust=False, **kw) for p, (con, _, _, _, kw) in PKGS.items()}
    finally:
        os.chdir(cwd)


def _subspaces(clusters, synth_case):
    """A fresh SubSpace of each package, without trims."""
    out = {}
    for p, (con, get, _, _, kw) in PKGS.items():
        cf = get.DataFetcher("dir", directoryName=synth_case["conDir"])
        out[p] = con.createSubSpace(Pf=1e-9, clust=clusters[p],
                                    conDatFetcher=cf, **kw)
    return out


def _rows(ss, p):
    """Every subspace and single row of a SubSpace as dicts, in station
    and row order."""
    out = []
    for frames in (ss.subspaces, ss.singles):
        for sta in sorted(frames):
            rows = frames[sta]
            out += ([r.to_dict() for _, r in rows.iterrows()] if p == "j"
                    else list(rows))
    return out


def _hold_trims(sub):
    """SampleTrims equal, start times, offsets and Offsets within 1e-9;
    returns the number of rows with trims."""
    got, want = _rows(sub["t"], "t"), _rows(sub["j"], "j")
    assert [(r["Station"], r["Name"]) for r in got] == \
        [(r["Station"], r["Name"]) for r in want]
    n = 0
    for g, w in zip(got, want):
        assert g["SampleTrims"] == w["SampleTrims"], (g["Name"], w["Name"])
        n += bool(g["SampleTrims"])
        for ev in w["Events"]:
            for k in ("starttime", "offset"):
                assert abs(g["Stats"][ev][k] - w["Stats"][ev][k]) <= 1e-9
        if isinstance(w["Offsets"], list):   # set by _updateOffsets
            np.testing.assert_allclose(g["Offsets"], w["Offsets"], rtol=0,
                                       atol=1e-9)
    return n


def test_auto_pick_times_matches_jax(clusters, synth_case):
    sub = _subspaces(clusters, synth_case)
    for ss in sub.values():
        ss.autoPickTimes(duration=20)
    n = _hold_trims(sub)
    assert n == len(_rows(sub["j"], "j")) > 0
    # rows that have trims keep them unless repick
    before = [dict(r["SampleTrims"]) for r in _rows(sub["t"], "t")]
    sub["t"].autoPickTimes(duration=5)
    assert [r["SampleTrims"] for r in _rows(sub["t"], "t")] == before
    for ss in sub.values():
        ss.autoPickTimes(duration=5, staTime=0.3, ltaTime=3.0, repick=True)
    _hold_trims(sub)


def _scripted(pick_mod, keep_going=True, pick_at=104.0):
    """A picker class of one package: P at ``pick_at`` samples of the
    first trace and Pend 200 samples later."""
    class Scripted:
        def __init__(self, st):
            s = st[0].stats
            wid = dict(network_code=s.network, station_code=s.station,
                       location_code=s.location, channel_code=s.channel)
            self._picks = [
                pick_mod.Pick(time=s.starttime + pick_at * s.delta,
                              phase_hint="P",
                              waveform_id=pick_mod.WaveformStreamID(**wid)),
                pick_mod.Pick(time=s.starttime + (pick_at + 200) * s.delta,
                              phase_hint="Pend",
                              waveform_id=pick_mod.WaveformStreamID(**wid))]
            self.KeepGoing = keep_going
    return Scripted


@pytest.mark.parametrize("keep_going", [True, False])
def test_pick_times_scripted_matches_jax(clusters, synth_case, keep_going):
    sub = _subspaces(clusters, synth_case)
    seen = {}
    for p, ss in sub.items():
        cls = _scripted(PKGS[p][2], keep_going)
        seen[p] = []

        def factory(st, _cls=cls, _seen=seen[p]):
            _seen.append([tr.stats.channel for tr in st])
            return _cls(st)
        ss.pickTimes(duration=20, pickerFactory=factory)
    assert seen["t"] == seen["j"] and seen["t"]
    n = _hold_trims(sub)
    if keep_going:
        assert n == len(_rows(sub["t"], "t"))
    else:
        # stopped after the first group, whose picks are kept
        assert len(seen["t"]) == 1 and n == 1
    for p, ss in sub.items():      # the window spans duration: no pick end
        ss.pickTimes(duration=None, repick=True, singles=False,
                     pickerFactory=_scripted(PKGS[p][2]))
    _hold_trims(sub)


def _read(path):
    return pd.read_csv(path).to_dict("records")


def _hold_files(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert abs(g["TimeStamp"] - w["TimeStamp"]) <= 1e-6
        assert {k: v for k, v in g.items() if k != "TimeStamp"} == \
            {k: v for k, v in w.items() if k != "TimeStamp"}
    return got


@pytest.mark.parametrize("keep_going", [True, False])
def test_pick_phases_matches_jax(clusters, synth_case, tmp_path,
                                 keep_going):
    paths = {p: str(tmp_path / ("%s.csv" % p)) for p in PKGS}
    kw = dict(fetch=synth_case["eventDir"],
              templatekey=synth_case["templateKey"],
              stationkey=synth_case["stationKey"])
    for p, (_, _, pick_mod, util, _) in PKGS.items():
        util.pickPhases(pickFile=paths[p], pickerFactory=_scripted(
            pick_mod, keep_going), **kw)
    rows = _hold_files(paths["t"], paths["j"])
    n_events = len(pd.read_csv(synth_case["templateKey"]))
    n_sta = len(pd.read_csv(synth_case["stationKey"]))
    assert len(rows) == (2 * n_events * n_sta if keep_going else 2)
    # a second run adds the pairs not yet picked, or none with skipIfExists
    for p, (_, _, pick_mod, util, _) in PKGS.items():
        util.pickPhases(pickFile=paths[p], pickerFactory=_scripted(
            pick_mod, pick_at=50.0), **kw)
    more = _hold_files(paths["t"], paths["j"])
    assert len(more) == 2 * n_events * n_sta
    assert [r["Station"] for r in more] == sorted(r["Station"] for r in more)
    sub = _subspaces(clusters, synth_case)
    for p, ss in sub.items():
        ss.attachPickTimes(pksFile=paths[p], defaultDuration=20)
    assert _hold_trims(sub) == len(_rows(sub["t"], "t"))


def test_auto_pick_phases_matches_jax_and_attaches(clusters, synth_case,
                                                   tmp_path):
    paths = {p: str(tmp_path / ("%s_auto.csv" % p)) for p in PKGS}
    for p, (_, _, _, util, _) in PKGS.items():
        util.autoPickPhases(templateKey=synth_case["templateKey"],
                            stationKey=synth_case["stationKey"],
                            fetch=synth_case["eventDir"], fileName=paths[p],
                            tb4=10, taft=60)
    rows = _hold_files(paths["t"], paths["j"])
    assert list(rows[0]) == ["TimeStamp", "Station", "Event", "Phase"]
    sub = _subspaces(clusters, synth_case)
    for p, ss in sub.items():
        ss.attachPickTimes(pksFile=paths[p], defaultDuration=20)
    assert _hold_trims(sub) > 0


# ---------------------------------------------------------------------------
# streamPick's headless contract (tests/test_streampick.py on the port)
# ---------------------------------------------------------------------------


def _stream(stations=("S00",), channels=("BHZ", "BHN"), n=500, sr=25.0):
    rng = np.random.default_rng(7)
    trs = []
    for sta in stations:
        for ch in channels:
            d = rng.standard_normal(n)
            d[200:220] += 8.0  # an obvious onset
            trs.append(Trace(d, header=dict(network="TA", station=sta,
                                            channel=ch, sampling_rate=sr,
                                            starttime=1000.0)))
    return Stream(trs)


@pytest.fixture
def pick(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # .pick_filters lands in tmp
    return tpick.streamPick(_stream(), show=False)


def test_stream_pick_set_overwrite_and_remove(pick):
    with pytest.raises(ValueError):
        tpick.streamPick(Stream([]), show=False)
    pick.feed_key("q", xdata=200.0, channel="BHZ")
    assert len(pick._picks) == 1
    p = pick._picks[0]
    assert p.phase_hint == "P"
    assert abs(p.time.timestamp - (1000.0 + 200.0 / 25.0)) < 1e-9
    assert p["waveform_id"]["channel_code"] == "BHZ"
    assert p.waveform_id.station_code == "S00"
    assert p.polarity in ("positive", "negative", "undecideable")
    pick.feed_key("q", xdata=100.0, channel="BHZ")   # overwrites
    assert len(pick._picks) == 1
    assert abs(pick._picks[0].time.timestamp - 1004.0) < 1e-9
    pick.feed_key("w", xdata=300.0, channel="BHZ")
    pick.feed_key("a", xdata=260.0, channel="BHN")
    pick.feed_key("t", xdata=280.0, channel="BHN")
    assert {p.phase_hint for p in pick._picks} == {"P", "S", "Pend",
                                                   "Custom"}
    pick.feed_key("r", channel="BHN")
    assert {p.waveform_id.channel_code for p in pick._picks} == {"BHZ"}


def test_stream_pick_keep_going(pick):
    assert pick.KeepGoing is False
    pick.feed_key("v")
    assert pick.KeepGoing is True and pick._closed
    assert os.path.exists(".pick_filters")
    p2 = tpick.streamPick(_stream(), show=False)
    p2.feed_key("escape")
    assert p2.KeepGoing is False and p2._closed


def test_stream_pick_key_through_the_agg_canvas(pick):
    from matplotlib.backend_bases import KeyEvent
    ax = pick.fig.get_axes()[0]
    x, y = ax.transData.transform((150.0, 0.0))
    KeyEvent("key_press_event", pick.fig.canvas, "q", x, y)._process()
    assert len(pick._picks) == 1
    assert pick._picks[0].waveform_id.channel_code == ax.channel
    assert abs(pick._picks[0].time.timestamp - (1000.0 + 150.0 / 25.0)) < .04


def test_stream_pick_station_cycle_and_display_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    pk = tpick.streamPick(_stream(stations=("S00", "S01")), show=False,
                          bpfilter=[dict(freqmin=1.0, freqmax=8.0, corners=2,
                                         zerophase=True)])
    assert pk._current_stname == "S00"
    pk.feed_key("q", xdata=50.0, channel="BHZ")
    pk.feed_key("c")
    assert pk._current_stname == "S01"
    assert pk._getPicks() == []
    pk.feed_key("q", xdata=60.0, channel="BHZ")
    assert len(pk._picks) == 2 and len(pk._getPicks()) == 1
    pk.feed_key("x")
    assert pk._current_stname == "S00"
    pk.feed_key("f")
    assert pk._filter_index == 0
    pk.feed_key("1")
    pk.feed_key("2")
    pk.feed_key("f")
    assert pk._filter_index is None
    assert len(pk._picks) == 2
