"""detex_torch's detector construction on the CPU against detex_tpu's:
the host modules (classic_sta_lta, stats, align, ops/svd) on seeded
inputs, and the synthetic Case1 analog (the ``synth_case`` fixture of
tests/conftest.py) through createCluster -> createSubSpace ->
attachPickTimes -> SVD -> SubSpace.detex in both packages.

The port takes plain inputs, so the template streams and the null and
continuous chunks come from detex_tpu's fetchers, converted to the port's
Streams here, the only place that knows both packages; the template rows
come from detex_tpu's template key. Both build at dtype "double" with
conDatNum 4 and detex_tpu runs without its device mesh (DETEX_TPU_MESH=0).

Tolerances: classic_sta_lta, stats.* and alignment delays exact (the
delays also on detex_tpu's own CC and lag matrices fed to the port, so the
clustering logic is held apart from correlation rounding); svd_basis and
frac_energy 1e-12 at dtype "double", projectors U U^T and singular values
1e-5 at "single" (singular vectors are signed arbitrarily); the Case1 CC
matrices 1e-5, subsample 1e-4, lags exact where the float64 oracle's peak
is clear; linkage from detex_tpu's CC exact; clusters, singles,
SampleTrims, NumBasis and the used basis size identical; AlignedTD
1e-12 relative (the two packages' float64 filters round apart); Offsets
1e-9; FracEnergy 1e-9; beta parameters and thresholds 1e-5 relative (both
fit the float32 DS of the same null chunks, which round apart); histogram
totals exact; SubSpace.detex rows in the same order with STMP exact and
DS within 2e-5, and the info tables equal.
"""
import os

import numpy as np
import pandas as pd
import pytest
from scipy.cluster.hierarchy import linkage

from detex_tpu import align as jalign
from detex_tpu import construct as jcon
from detex_tpu import stats as jstats
from detex_tpu import util as jutil
from detex_tpu.core.utc import UTCDateTime as JUTC
from detex_tpu.data import fetcher as getdata
from detex_tpu.data.keys import readKey
from detex_tpu.ops import stalta as jstalta
from detex_tpu.ops import svd as jsvd
from detex_torch import align as talign
from detex_torch import construct as tcon
from detex_torch import stats as tstats
from detex_torch import util as tutil
from detex_torch.ops import stalta as tstalta
from detex_torch.ops import svd as tsvd
from detex_torch.subspace import Cluster
from test_torch_detect import _port_stream
from test_torch_xcorr import ccx2_oracle, peak_clear

FILT = [1, 8, 2, True]
TRIM = [10, 60]
CON_DAT_NUM = 4


# ---------------------------------------------------------------------------
# host modules
# ---------------------------------------------------------------------------


def test_classic_sta_lta_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(5000) * 0.1
    x[3000:3200] += np.sin(np.arange(200)) * 5
    x[4000:4010] = 0.0
    for nsta, nlta in ((20, 500), (0.4, 3), (1, 1), (50.5, 4999)):
        np.testing.assert_array_equal(tstalta.classic_sta_lta(x, nsta, nlta),
                                      jstalta.classic_sta_lta(x, nsta, nlta))
    np.testing.assert_array_equal(tstalta.classic_sta_lta(np.zeros(50), 2,
                                                          10), np.zeros(50))


def test_stats_match_jax():
    for lam in (0.0, 0.3, 12.0, 400.0):
        got, want = tstats._poisson_terms(lam), jstats._poisson_terms(lam)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for args in ((0.02, 3, 500, 10.0, 2.0), (0.3, 1, 80, 0.0, 0.0),
                 (0.05, 4, 900, 60.0, 5.0)):
        assert tstats.dnc_beta_sf(*args) == jstats.dnc_beta_sf(*args)
    assert tstats.null_threshold(1e-9, 3, 900) == \
        jstats.null_threshold(1e-9, 3, 900)
    avg = np.array([0.0, 0.55, 0.8, 0.9, 0.94, 0.97, 1.0])
    got, want = (m.dim_of_max_pd(avg, 1500, 1e-8, 200.0)
                 for m in (tstats, jstats))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert tstats.dim_of_max_pd([0.0], 100, 1e-8, 5.0)[0] == 1


def _tree(rng, m, tie=False):
    """A random [m, m] upper-triangle CC / lag pair and its linkage; with
    ``tie`` every cross CC of two blocks is equal, so the row-major
    tie-break decides."""
    cc = np.full((m, m), np.nan)
    lag = np.zeros((m, m))
    iu = np.triu_indices(m, 1)
    cc[iu] = rng.uniform(0.2, 0.95, len(iu[0]))
    lag[iu] = rng.integers(-60, 60, len(iu[0])) * 3
    if tie:
        cc[:m // 2, m // 2:] = 0.9
    dis = tcon.DISSIM_OFFSET - cc
    np.testing.assert_array_equal(tcon._condensed(dis), jcon._condensed(dis))
    np.testing.assert_array_equal(tcon._flatNoNan(dis), jcon._flatNoNan(dis))
    return cc, lag, linkage(jcon._flatNoNan(jcon.DISSIM_OFFSET - cc))


@pytest.mark.parametrize("tie", [False, True])
def test_alignment_matches_jax(tie):
    rng = np.random.default_rng(3 + tie)
    for m in (2, 5, 11):
        cc, lag, link = _tree(rng, m, tie)
        d_t = talign.alignment_delays(link, cc, lag)
        d_j = jalign.alignment_delays(link, cc, lag)
        np.testing.assert_array_equal(d_t, d_j)
        assert d_t.min() == 0
        evs = ["e%02d" % k for k in range(m)]
        wfs = {e: rng.standard_normal(900) for e in evs}
        got, want = (mod.align_and_trim(wfs, evs, d_t)
                     for mod in (talign, jalign))
        assert list(got) == list(want)
        for e in evs:
            np.testing.assert_array_equal(got[e], want[e])
    d = np.array([0, 3, 3, 4, 200, 3, 2, 3])
    evs = ["a", "b", "c", "d", "e", "f", "g", "h"]
    assert talign._id_align_problems(evs, d) == \
        jalign._id_align_problems(evs, d)
    assert "event e is an outlier" in talign._id_align_problems(evs, d)
    one = talign.alignment_delays(np.zeros((0, 4)), np.full((1, 1), np.nan),
                                  np.zeros((1, 1)))
    np.testing.assert_array_equal(one, [0])


def test_svd_basis_and_frac_energy_match_jax():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((7, 600)) + 3 * np.sin(np.arange(600) / 9.0)
    A0 = A - A.mean(axis=1, keepdims=True)
    for norm in (False, True):
        U, s = tsvd.svd_basis(A0, normalize=norm, dtype="double",
                              device="cpu")
        Uj, sj = jsvd.svd_basis(A0, normalize=norm, dtype="double")
        np.testing.assert_allclose(U, Uj, atol=1e-12)
        np.testing.assert_allclose(s, sj, rtol=1e-12)
        np.testing.assert_allclose(
            tsvd.frac_energy(U, A, dtype="double", device="cpu"),
            jsvd.frac_energy(Uj, A, dtype="double"), atol=1e-12)
        U1, s1 = tsvd.svd_basis(A0, normalize=norm, dtype="single",
                                device="cpu")
        Uj1, sj1 = jsvd.svd_basis(A0, normalize=norm, dtype="single")
        assert U1.dtype == s1.dtype == np.float64 and U1.shape == (600, 7)
        np.testing.assert_allclose(U1 @ U1.T, Uj1 @ Uj1.T, atol=1e-5)
        np.testing.assert_allclose(s1, sj1, rtol=1e-5)
        np.testing.assert_allclose(
            tsvd.frac_energy(U1, A, dtype="single", device="cpu"),
            jsvd.frac_energy(Uj1, A, dtype="single"), atol=1e-5)


# ---------------------------------------------------------------------------
# the Case1 analog through both packages
# ---------------------------------------------------------------------------


def _port_inputs(paths):
    """The port's createCluster inputs from detex_tpu's event fetcher and
    keys: {sta: {event: Stream}} as getTemData yields them (cut TRIM
    around the origin) and {event: {"time", "mag"}}."""
    stakey = readKey(paths["stationKey"], "station")
    temkey = readKey(paths["templateKey"], "template")
    efetch = getdata.quickFetch(paths["eventDir"])
    streams = {}
    for _, srow in stakey.iterrows():
        sta = "%s.%s" % (srow.NETWORK, srow.STATION)
        for st, ev in efetch.getTemData(
                temkey, stakey[stakey.STATION == srow.STATION], TRIM[0],
                TRIM[1], returnName=True):
            streams.setdefault(sta, {})[ev] = _port_stream(st)
    templates = {}
    for _, r in temkey.iterrows():
        templates.setdefault(r.NAME, {"time": r.TIME, "mag": r.MAG})
    return streams, templates, stakey


def _null_chunks(cfetcher, stakey, conDatNum):
    """chunks(sta) for the port's FAS: the fetcher's deterministic random
    null chunks over the station's span, as detex_tpu's _collectChunks
    draws them."""
    def gen(sta):
        skey = stakey[stakey.STATION == sta.split(".")[1]]
        u1 = JUTC(skey.iloc[0].STARTTIME)
        u2 = JUTC(skey.iloc[0].ENDTIME)
        for st in cfetcher.getConData(skey, utcstart=u1, utcend=u2,
                                      randSamps=conDatNum * 4):
            yield _port_stream(st), None, None
    return gen


def _pick_rows(paths):
    """The phase picks as rows, read as detex_tpu reads them (pandas'
    float parser, which can round a timestamp one ULP away from Python's
    float(): the rows keep both packages on the same pick times)."""
    return pd.read_csv(paths["phaseKey"]).to_dict("records")


@pytest.fixture(scope="module")
def case(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("tconstruct")
    os.chdir(wd)
    clust = jcon.createCluster(
        CCreq=0.5, fetch_arg=synth_case["eventDir"], filt=FILT,
        stationKey=synth_case["stationKey"],
        templateKey=synth_case["templateKey"], trim=TRIM, saveclust=False,
        dtype="double", fileName=str(wd / "c.pkl"))
    cfetcher = getdata.DataFetcher("dir", directoryName=synth_case["conDir"])
    ss = jcon.createSubSpace(Pf=1e-9, clust=clust, minEvents=2,
                             conDatFetcher=cfetcher)
    ss.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=CON_DAT_NUM,
           useSingles=True, backupThreshold=0.25)

    streams, templates, stakey = _port_inputs(synth_case)
    tcl = tcon.createCluster(streams=streams, templates=templates,
                             CCreq=0.5, filt=FILT, trim=TRIM, dtype="double",
                             device="cpu")
    tss = tcon.createSubSpace(clust=tcl, Pf=1e-9, minEvents=2,
                              conDatDuration=cfetcher.conDatDuration,
                              conBuff=cfetcher.conBuff)
    tss.attachPickTimes(pksFile=_pick_rows(synth_case), defaultDuration=20)
    tss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=CON_DAT_NUM,
            useSingles=True, backupThreshold=0.25,
            chunks=_null_chunks(cfetcher, stakey, CON_DAT_NUM))
    return dict(clust=clust, ss=ss, tcl=tcl, tss=tss, cfetcher=cfetcher,
                stakey=stakey, wd=wd)


def _pairs(case):
    """(sta, j trdf row, port trdf row) per station."""
    jt = case["clust"].trdf
    for k, trow in enumerate(case["tcl"].trdf):
        jrow = jt.iloc[k]
        assert trow["Station"] == jrow.Station
        assert trow["Events"] == list(jrow.Events)
        yield trow["Station"], jrow, trow


def test_case1_cc_lag_subsample_matrices(case):
    clear = 0
    for sta, jrow, trow in _pairs(case):
        m = len(trow["Events"])
        cc = jcon._square_from_df(jrow.CCs, m)
        lag = jcon._square_from_df(jrow.Lags, m, fill=0.0)
        sub = jcon._square_from_df(jrow.Subsamp, m)
        for got, want in ((trow["CCs"], cc), (trow["Subsamp"], sub)):
            assert got.shape == (m, m)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        iu = np.triu_indices(m, 1)
        assert np.abs(trow["CCs"][iu] - cc[iu]).max() <= 1e-5
        assert np.abs(trow["Subsamp"][iu] - sub[iu]).max() <= 1e-4
        for i, j in zip(*iu):
            ei, ej = trow["Events"][i], trow["Events"][j]
            _, olag, curve = ccx2_oracle(trow["MPtd"][ei], trow["MPtd"][ej],
                                         3)
            if peak_clear(curve):
                clear += 1
                assert trow["Lags"][i, j] == lag[i, j] == olag
    assert clear >= 30


def test_case1_clusters_and_singles_identical(case):
    for jc, tc in zip(case["clust"].clusters, case["tcl"].clusters):
        assert tc.station == jc.station and tc.key == jc.key
        assert tc.clusts == jc.clusts and tc.singles == jc.singles
        assert len(tc.clusts) == 2 and len(tc.singles) == 1
    case["tcl"].updateReqCC(0.98)
    case["clust"].updateReqCC(0.98)
    try:
        for jc, tc in zip(case["clust"].clusters, case["tcl"].clusters):
            assert tc.clusts == jc.clusts and tc.singles == jc.singles
    finally:
        case["tcl"].updateReqCC(0.5)
        case["clust"].updateReqCC(0.5)


def test_case1_linkage_and_delays_from_jax_cc_exact(case):
    """detex_tpu's CC and lag matrices fed to the port: linkage, clusters
    and every cluster's alignment delays come out exactly detex_tpu's."""
    for (sta, jrow, trow), jc in zip(_pairs(case), case["clust"].clusters):
        m = len(trow["Events"])
        cc = jcon._square_from_df(jrow.CCs, m)
        lag = jcon._square_from_df(jrow.Lags, m, fill=0.0)
        link = linkage(tcon._flatNoNan(tcon.DISSIM_OFFSET - cc))
        np.testing.assert_array_equal(link, jrow.Link)
        tc = Cluster(sta, trow["Events"], link, 0.5)
        assert tc.clusts == jc.clusts and tc.singles == jc.singles
        for members in jc.clusts:
            pos = [trow["Events"].index(e) for e in sorted(members)]
            sub_cc = cc[np.ix_(pos, pos)]
            sub_lag = lag[np.ix_(pos, pos)]
            lower = ~np.triu(np.ones((len(pos),) * 2, bool), 1)
            sub_cc[lower] = np.nan
            sub_lag[lower] = 0.0
            sl = linkage(tcon._flatNoNan(tcon.DISSIM_OFFSET - sub_cc))
            np.testing.assert_array_equal(
                talign.alignment_delays(sl, sub_cc, sub_lag),
                jalign.alignment_delays(sl, sub_cc, sub_lag))


def _rows(case, singles=False):
    """(sta, detex_tpu row, port row) of every subspace (or single)."""
    jd = case["ss"].singles if singles else case["ss"].subspaces
    td = case["tss"].singles if singles else case["tss"].subspaces
    assert sorted(jd) == sorted(td)
    for sta in sorted(jd):
        assert len(jd[sta]) == len(td[sta])
        for (_, jr), tr in zip(jd[sta].iterrows(), td[sta]):
            assert tr["Name"] == jr.Name and tr["Events"] == list(jr.Events)
            yield sta, jr, tr


def test_case1_aligned_waveforms_trims_and_offsets(case):
    n = 0
    for sta, jr, tr in list(_rows(case)) + list(_rows(case, True)):
        n += 1
        assert tr["SampleTrims"] == jr.SampleTrims
        np.testing.assert_allclose(np.asarray(tr["Offsets"], float),
                                   np.asarray(jr.Offsets, float), rtol=0,
                                   atol=1e-9)
        wfs_t = tr["AlignedTD"] if "AlignedTD" in tr else tr["MPtd"]
        wfs_j = jr.AlignedTD if "AlignedTD" in tr else jr.MPtd
        assert list(wfs_t) == list(wfs_j)
        for e in wfs_j:
            assert len(wfs_t[e]) == len(wfs_j[e])
            scale = np.abs(wfs_j[e]).max()
            assert np.abs(wfs_t[e] - wfs_j[e]).max() <= 1e-12 * scale
        for e in tr["Events"]:
            for k in ("starttime", "offset", "origintime", "magnitude"):
                assert abs(tr["Stats"][e][k] - jr.Stats[e][k]) <= 1e-9
    assert n == 6


def test_case1_svd_basis_sizes_and_frac_energy(case):
    for sta, jr, tr in _rows(case):
        assert tr["SVDdefined"] and tr["NumBasis"] == jr.NumBasis
        assert len(tr["UsedSVDKeys"]) == len(jr.UsedSVDKeys)
        np.testing.assert_allclose(sorted(tr["SVD"]), sorted(jr.SVD),
                                   rtol=1e-9)
        for k in ("Average", "Minimum"):
            np.testing.assert_allclose(tr["FracEnergy"][k],
                                       jr.FracEnergy[k], rtol=0, atol=1e-9)
        Ut = np.array([tr["SVD"][x] for x in tr["UsedSVDKeys"]])
        Uj = np.array([jr.SVD[x] for x in jr.UsedSVDKeys])
        np.testing.assert_allclose(Ut.T @ Ut, Uj.T @ Uj, atol=1e-9)


def test_case1_fas_and_thresholds(case):
    n = 0
    for singles in (False, True):
        for sta, jr, tr in _rows(case, singles):
            n += 1
            tf = tr["FAS"][0] if singles else tr["FAS"]
            jf = jr.FAS[0] if singles else jr.FAS
            np.testing.assert_array_equal(tf["bins"], jf["bins"])
            assert tf["hist"].sum() == jf["hist"].sum()
            assert np.abs(tf["hist"] - jf["hist"]).sum() <= 4
            np.testing.assert_allclose(tf["betadist"][:2],
                                       jf["betadist"][:2], rtol=1e-5)
            assert tuple(tf["betadist"][2:]) == (0, 1)
            np.testing.assert_allclose(tf["nnlf"], jf["nnlf"], rtol=1e-5)
            np.testing.assert_allclose(tf["normdist"], jf["normdist"],
                                       rtol=1e-5)
            assert 0 < tr["Threshold"] < 1
            np.testing.assert_allclose(tr["Threshold"], jr.Threshold,
                                       rtol=1e-5)
    assert n == 6


def test_case1_subspace_detex_rows_match_jax(case, monkeypatch, tmp_path):
    monkeypatch.setenv("DETEX_TPU_MESH", "0")
    ss, tss = case["ss"], case["tss"]
    t0 = min(JUTC(x).timestamp for x in ss.clusters.temkey.TIME)
    start = np.floor(t0 / 3600.0) * 3600.0
    u0, u1 = JUTC(start), JUTC(start + 5 * 3600.0)
    db_j, db_t = str(tmp_path / "jax.db"), str(tmp_path / "torch.db")
    ss.detex(utcStart=u0, utcEnd=u1, subspaceDB=db_j, useSingles=True,
             batchSize=8)
    stakey, cf = case["stakey"], case["cfetcher"]

    def chunks(sta):
        skey = stakey[stakey.STATION == sta.split(".")[1]]
        for st, a, b in cf.getConData(skey, utcstart=u0, utcend=u1,
                                      returnTimes=True):
            yield (None if st is None else _port_stream(st)), a, b

    tss.detex(chunks=chunks, subspaceDB=db_t, useSingles=True,
              batchSize=8)
    for table in ("ss_df", "sg_df"):
        want = jutil.loadSQLite(db_j, table)
        got = tutil.loadSQLite(db_t, table, columns=True)
        assert len(want) > 0 and len(got["STMP"]) == len(want)
        assert [str(x) for x in got["Name"]] == list(want.Name)
        assert list(got["Sta"]) == list(want.Sta)
        np.testing.assert_array_equal(got["STMP"], np.asarray(want.STMP))
        assert np.abs(got["DS"] - np.asarray(want.DS)).max() <= 2e-5
    for table in ("ss_info", "sg_info", "filt_params", "ss_hist", "sg_hist"):
        want = jutil.loadSQLite(db_j, table)
        got = tutil.loadSQLite(db_t, table, columns=True)
        assert list(got) == list(want.columns), table
        for col in want.columns:
            w = np.asarray(want[col])
            if col in ("Threshold", "beta1", "beta2"):
                np.testing.assert_allclose(got[col], w.astype(float),
                                           rtol=1e-5)
            elif col != "Value":
                assert [str(x) for x in got[col]] == [str(x) for x in w]


def test_attach_picks_from_the_csv(case, synth_case):
    """attachPickTimes on the CSV path (the standard library's csv) gives
    the trims of the rows read by pandas, and offsets within one ULP of a
    POSIX timestamp."""
    tss = tcon.createSubSpace(clust=case["tcl"], Pf=1e-9, minEvents=2)
    tss.attachPickTimes(pksFile=synth_case["phaseKey"], defaultDuration=20)
    n = 0
    for singles in (False, True):
        got, want = ((s.singles if singles else s.subspaces)
                     for s in (tss, case["tss"]))
        for sta in want:
            for g, w in zip(got[sta], want[sta]):
                n += 1
                assert g["SampleTrims"] == w["SampleTrims"]
                np.testing.assert_allclose(g["Offsets"], w["Offsets"],
                                           rtol=0, atol=5e-7)
    assert n == 6


def test_fas_past_128_detectors_of_one_length():
    """FAS scans 130 single templates of one length as one bank (pad_rows:
    136 rows) through run_bank_batch, which has no 128-template ceiling:
    every detector gets its fit, and the first and last equal the fits of
    the float64 oracle DS (ds_numpy) of the same filtered chunks within
    1e-4 relative."""
    from types import SimpleNamespace

    from detex_torch import fas
    from detex_torch.core import Stream, Trace
    from detex_torch.ops import ds as tds
    rng = np.random.default_rng(11)
    n_c, sr, L = 200, 25.0, 12000
    rows = []
    for k in range(130):
        ev = "e%03d" % k
        rows.append(dict(Station="XX.S1", Name="SG%d" % k, MPtd={
            ev: rng.standard_normal(3 * n_c + 30)},
            SampleTrims={"Starttime": 15, "Endtime": 15 + 3 * n_c},
            Stats={ev: {"Nc": 3, "sampling_rate": sr}}))

    def chunks(sta):
        for k in range(5):
            x = np.random.default_rng((12, k)).standard_normal((3, L))
            yield Stream([Trace(x[c], dict(
                network="XX", station="S1", channel="BH" + "ENZ"[c],
                sampling_rate=sr, starttime=1e9 + L / sr * k))
                for c in range(3)]), None, None

    cl = SimpleNamespace(filt=FILT, decimate=None)
    res = fas._initFAS(rows, 3, cl, chunks, L / sr, dtype="double",
                       issubspace=False, device="cpu")
    assert len(res) == 130 and all("betadist" in r for r in res)
    acc, count, scount = fas._collectChunks(chunks, "XX.S1", FILT, None,
                                            "double", 3, 3, 0.5, 5, 7.5)
    assert scount == 3
    for k in (0, 129):
        U, _, _ = fas._loadMPSingles(rows[k])
        ds64 = np.concatenate([tds.ds_numpy(x, U, 3) for x in acc])
        want = fas._fit_null(ds64, res[k]["bins"])
        assert res[k]["hist"].sum() == want["hist"].sum() == len(ds64)
        np.testing.assert_allclose(res[k]["betadist"][:2],
                                   want["betadist"][:2], rtol=1e-4)


@pytest.mark.parametrize("window", [(2.0, 5.0), (-3.0, 4.0), (6.0, 12.0),
                                    (-2.0, None), (None, 14.5)])
def test_trim_pad_matches_jax(window):
    """Trace.trim with pad (createCluster's enforceOrigin) keeps the whole
    window, zero-filled outside the trace, as detex_tpu's does."""
    from detex_tpu.core.stream import Trace as JTrace
    from detex_torch.core import Trace as TTrace
    x = np.arange(200, dtype=np.float64) + 1.0
    t0 = 1e9
    hdr = dict(network="XX", station="S1", channel="BHZ",
               sampling_rate=20.0, starttime=t0)
    a, b = (None if w is None else t0 + w for w in window)
    got = TTrace(x.copy(), dict(hdr)).trim(a, b, pad=True, fill_value=0.0)
    want = JTrace(x.copy(), dict(hdr)).trim(a, b, pad=True, fill_value=0.0)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.stats.starttime.timestamp == want.stats.starttime.timestamp
    assert got.stats.npts == len(want.data)
