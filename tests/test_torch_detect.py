"""detex_torch's detection engine (detect.detex) on the CPU against
detex_tpu's SubSpace.detex on the synthetic Case1 analog (the
``synth_case`` fixture of tests/conftest.py).

The detectors are pulled off the SubSpace as detex_tpu's _prepareDetectors
reads them (as tests/test_parity_oracle.py pulls them), and the
continuous chunks come from the same fetcher: its Streams are converted to
the port's Streams here, the only place that knows both packages.
detex_tpu runs without its device mesh (DETEX_TPU_MESH=0), so both engines
scan the same batches and write their rows in the same order; both restrict
the scan to the hours of the planted events.

Each case writes ss_df (subspace detectors) or sg_df (single templates)
through both engines; the rows must come out the same in number and
order, with Name and Sta equal, STMP / MSTAMPmin / MSTAMPmax within 1e-7,
DS within 2e-5 (dtype "single") or 1e-6 ("double"), Mag / SNR / ProEnMag
with equal NaN patterns and within 1e-5, and every detector's histogram
total exact. Cases: dtype single and double, single templates, trigCon 1
with staltaThreshold, batchSize 1, fillZeros, and devicePrep with
decimation (a SubSpace built at decimate 2).

One case is the port's alone: a devicePrep station followed by a station
that falls back to the host prep, against the host prep throughout.
"""
import os

import numpy as np
import pandas as pd
import pytest

from detex_tpu import construct, util
from detex_tpu.core.utc import UTCDateTime as JUTC
from detex_tpu.data import fetcher as getdata
from detex_torch import detect as tdetect
from detex_torch import util as tutil
from detex_torch.core import Stream as TStream
from detex_torch.core import Trace as TTrace
from detex_torch.parallel import scan as tscan

# the scan window from the hour of the first template event: five hours
# (five chunks a station) holding events of all three sources, one of them
# not in the template key; nine hours (a batch of 8 chunks and a padded
# batch of 1 a station, two more events) for the "single" case
SPAN = 5 * 3600.0
SPAN_TWO_BATCHES = 9 * 3600.0


def _subspace(synth_case, wd, decimate=None, filt=(1, 8, 2, True)):
    os.chdir(wd)
    clust = construct.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=list(filt),
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=[10, 60],
        saveclust=False, dtype="double", decimate=decimate,
        fileName=str(wd / "c.pkl"))
    cfetcher = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    ss = construct.createSubSpace(Pf=1e-9, clust=clust, minEvents=2,
                                  conDatFetcher=cfetcher)
    ss.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=4, useSingles=True,
           backupThreshold=0.25)
    ss.setSinglesThresholds()
    return ss


@pytest.fixture(scope="module")
def ss(synth_case, tmp_path_factory):
    return _subspace(synth_case, tmp_path_factory.mktemp("tdetect"))


@pytest.fixture(scope="module")
def ss_dec(synth_case, tmp_path_factory):
    return _subspace(synth_case, tmp_path_factory.mktemp("tdetect_dec"),
                     decimate=2, filt=(1, 5, 2, True))


def _window(ss, span):
    t0 = min(JUTC(x).timestamp for x in ss.clusters.temkey.TIME)
    start = np.floor(t0 / 3600.0) * 3600.0
    return JUTC(start), JUTC(start + span)


def _stations(ss, issubspace):
    """The plain station inputs of the port's engine: per station its
    channels and sampling rates (per event) and the detectors, read off
    the SubSpace rows as detex_tpu's _prepareDetectors reads them."""
    out = {}
    frames = ss.subspaces if issubspace else ss.singles
    for sta, df in frames.items():
        dets = []
        for _, row in df.iterrows():
            events = list(row.Events)
            if issubspace:
                U = np.array([row.SVD[x] for x in row.UsedSVDKeys])
                tr = row.SampleTrims
                WFs = np.array([row.AlignedTD[x][tr["Starttime"]:
                                                 tr["Endtime"]]
                                if "Starttime" in tr else row.AlignedTD[x]
                                for x in events])
            else:
                mptd = list(row.MPtd.values())[0]
                tr = row.SampleTrims
                upr = mptd[tr["Starttime"]:tr["Endtime"]] if tr else mptd
                U = np.array([upr / np.linalg.norm(upr)])
                WFs = np.array([upr])
            dets.append(dict(
                name=row.Name, U=U, WFs=WFs, events=events,
                mags=[row.Stats[x]["magnitude"] for x in events],
                offsets=row.Offsets, threshold=row.Threshold))
        if not dets:
            continue
        row = df.iloc[0]
        out[sta] = dict(channels=dict(row.Channels),
                        sr=[row.Stats[x]["sampling_rate"]
                            for x in row.Events],
                        detectors=dets)
    return out


def _port_stream(st):
    """A detex_tpu Stream as the port's: same data and header fields."""
    out = TStream()
    for tr in st:
        s = tr.stats
        out.append(TTrace(np.array(tr.data, copy=True), dict(
            network=s.network, station=s.station, location=s.location,
            channel=s.channel, sampling_rate=s.sampling_rate,
            starttime=s.starttime.timestamp)))
    return out


def _chunks(ss, utc0, utc1):
    """chunks(sta) for the port's engine: the fetcher's chunks of the
    station over [utc0, utc1), as port Streams."""
    def gen(sta):
        skey = ss.clusters.stakey
        skey = skey[skey.STATION == sta.split(".")[1]]
        for st, u1, u2 in ss.cfetcher.getConData(
                skey, utcstart=utc0, utcend=utc1, returnTimes=True):
            yield (None if st is None else _port_stream(st)), u1, u2
    return gen


# case -> (table, SubSpace fixture, detex keyword arguments, DS atol)
CASES = {
    "single": ("ss_df", "ss", dict(dtype="single"), 2e-5),
    "double": ("ss_df", "ss", dict(dtype="double"), 1e-6),
    "singles": ("sg_df", "ss", dict(dtype="single"), 2e-5),
    "trigcon1": ("ss_df", "ss", dict(dtype="single", trigCon=1,
                                     staltaThreshold=4.0), 2e-5),
    "batch1": ("ss_df", "ss", dict(dtype="single", batchSize=1), 2e-5),
    "fillzeros": ("ss_df", "ss", dict(dtype="single", fillZeros=True),
                  2e-5),
    "deviceprep": ("ss_df", "ss_dec", dict(dtype="single", devicePrep=True,
                                           estimateMags=False), 2e-5),
}


def _close(g, w, atol):
    g = np.asarray(g, np.float64)
    w = np.asarray(w, np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    assert np.abs(g[m] - w[m]).max(initial=0.0) <= atol


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_rows_match_jax(request, monkeypatch, tmp_path, case):
    table, fix, kw, ds_tol = CASES[case]
    ss = request.getfixturevalue(fix)
    monkeypatch.setenv("DETEX_TPU_MESH", "0")
    issub = table == "ss_df"
    kw = dict(dict(batchSize=8, estimateMags=True), **kw)
    utc0, utc1 = _window(ss, SPAN_TWO_BATCHES if case == "single" else SPAN)
    dtype = kw.pop("dtype")
    saved = ss.dtype
    ss.dtype = dtype
    db_j = str(tmp_path / "jax.db")
    try:
        ss.detex(utcStart=utc0, utcEnd=utc1, subspaceDB=db_j,
                 useSubSpaces=issub, useSingles=not issub, **kw)
    finally:
        ss.dtype = saved
    want = util.loadSQLite(db_j, table)
    hist_j = ss.histSubSpaces if issub else ss.histSingles

    db_t = str(tmp_path / "torch.db")
    hist_t = tdetect.detex(
        _stations(ss, issub), _chunks(ss, utc0, utc1), subspaceDB=db_t,
        conDatDuration=ss.cfetcher.conDatDuration,
        conBuff=ss.cfetcher.conBuff, filt=ss.clusters.filt,
        decimate=ss.clusters.decimate, issubspace=issub, dtype=dtype,
        device="cpu", **kw)
    got = tutil.loadSQLite(db_t, table, columns=True)

    assert want is not None and len(want) > 0
    assert got is not None and len(got["STMP"]) == len(want)
    assert [str(x) for x in got["Name"]] == [str(x) for x in want.Name]
    assert list(got["Sta"]) == list(want.Sta)
    for col in ("STMP", "MSTAMPmin", "MSTAMPmax"):
        _close(got[col], want[col], 1e-7)
    _close(got["DS"], want["DS"], ds_tol)
    for col in ("Mag", "SNR", "ProEnMag"):
        _close(got[col], pd.to_numeric(want[col]), 1e-5)
    assert set(hist_t) == set(hist_j)
    np.testing.assert_array_equal(hist_t["Bins"], hist_j["Bins"])
    for sta in hist_j:
        if sta == "Bins":
            continue
        assert sorted(hist_t[sta]) == sorted(hist_j[sta])
        for name, counts in hist_j[sta].items():
            assert hist_t[sta][name].sum() == counts.sum(), (sta, name)


def _two_station_inputs(seed=7, L=35000, sr=25.0):
    """Two stations of one 1400 s chunk pair each: XX.S1 with a template of
    1680 samples (a demuxed bank devicePrep can filter), XX.S2 with one of
    1681 (not divisible by the 3 channels: a multiplexed bank, so its
    station falls back to the host prep). Each has an event in its second
    chunk."""
    rng = np.random.default_rng(seed)
    stations, data = {}, {}
    for sta, n, at in (("XX.S1", 1680, 9000), ("XX.S2", 1681, 20001)):
        u = rng.standard_normal(n)
        U = (u / np.linalg.norm(u))[None]
        X = rng.standard_normal((2, 3 * L))
        X[1, 3 * at:3 * at + n] += 150.0 * U[0]
        stations[sta] = dict(channels=["BHE", "BHN", "BHZ"], sr=sr,
                             detectors=[dict(name=sta[3:] + "d0", U=U,
                                             WFs=3.0 * U, mags=[1.0],
                                             events=["e0"], offsets=[0.0],
                                             threshold=0.3)])
        data[sta] = X

    def chunks(sta):
        for b in range(2):
            yield TStream([TTrace(data[sta][b, c::3].copy(), dict(
                network="XX", station=sta[3:], channel="BH" + "ENZ"[c],
                sampling_rate=sr, starttime=1e9 + 1400.0 * b))
                for c in range(3)]), None, None
    return stations, chunks


def test_deviceprep_station_then_host_prep_station(tmp_path):
    """A devicePrep station followed by one that falls back to the host
    prep: the first station's last batch, still in flight while the second
    station's banks are built, materializes with its own devicePrep (its
    chunks re-filtered on the host, the devicePrep gate margin), and the
    rows equal those of the same engine with the host prep throughout
    (STMP exact, DS within 2e-5: the devicePrep re-verify uploads its
    host-filtered chunks instead of gathering them from the kept batch)."""
    stations, chunks = _two_station_inputs()
    kw = dict(conDatDuration=1300.0, conBuff=100.0, filt=[1, 8, 2, True],
              batchSize=2, estimateMags=False, device="cpu")
    tscan.ROUTE_COUNTS.clear()
    tdetect.detex(stations, chunks, str(tmp_path / "dev.db"),
                  devicePrep=True, **kw)
    assert tscan.ROUTE_COUNTS.get("fused-net+fusedprep+devicePrep") == 1
    tdetect.detex(stations, chunks, str(tmp_path / "host.db"), **kw)
    dev = tutil.loadSQLite(str(tmp_path / "dev.db"), "ss_df")
    host = tutil.loadSQLite(str(tmp_path / "host.db"), "ss_df")
    assert [r["Sta"] for r in host] == ["XX.S1", "XX.S2"]
    assert [(r["Name"], r["Sta"], r["STMP"]) for r in dev] == \
        [(r["Name"], r["Sta"], r["STMP"]) for r in host]
    _close([r["DS"] for r in dev], [r["DS"] for r in host], 2e-5)
