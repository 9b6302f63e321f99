"""Pickles of the original Detex package into detex_torch's objects, on the
CPU, against detex_tpu's migrate: util.loadClusters / loadSubSpace hand
a pickle naming ``detex.*`` to detex_torch.migrate.

The pickles are made as tests/test_migrate.py makes them (its helpers
copied here): stand-in ``detex`` modules are registered for a moment,
Detex-shaped instances holding detex_tpu's DataFrames (built from the
``synth_case`` key files, tests/conftest.py, at dtype "double", SVD with
a threshold of 0.5) are pickled at protocol 2, and the modules are
removed, so that only a migrate can read the file.

Held: the migrated ClusterStream's stations, clusters, singles, ccReq
and fetcher equal detex_tpu's migrated ones, its CC / lag / subsample
matrices detex_tpu's squares exactly, and createSubSpace from it gives
detex_tpu's subspaces and singles; the migrated SubSpace's rows carry
detex_tpu's trims, bases, thresholds and offsets exactly, and its detex
over five hours gives detex_tpu's native ss_df and sg_df rows in order
with STMP exact and DS within 1e-6 (both at "double", on the per-chunk
path, batchSize 1, which detex_tpu compiles in seconds where its batched
scan takes half a minute on the CPU). The unpickler
turns Detex functions into placeholders that raise, refuses names
outside its list, and the tables' reader refuses a Detex pickle.
"""
import io
import os
import pickle
import sys
import types

import numpy as np
import pytest

from detex_tpu import construct as jcon
from detex_tpu import util as jutil
from detex_tpu.core.utc import UTCDateTime
from detex_tpu.data import fetcher as jget
import detex_torch
from detex_torch import migrate
from detex_torch import util as tutil
from detex_torch.subspace import ClusterStream, SubSpace


def _fake_detex_modules():
    det = types.ModuleType("detex")
    sub = types.ModuleType("detex.subspace")
    gd = types.ModuleType("detex.getdata")

    for name in ("ClusterStream", "Cluster", "SubSpace"):
        cls = type(name, (object,), {})
        cls.__module__ = "detex.subspace"
        setattr(sub, name, cls)
    DF = type("DataFetcher", (object,), {})
    DF.__module__ = "detex.getdata"
    gd.DataFetcher = DF

    def _loadDirectoryData(*a, **k):  # pickled by reference in fetchers
        return None
    _loadDirectoryData.__module__ = "detex.getdata"
    _loadDirectoryData.__qualname__ = "_loadDirectoryData"
    gd._loadDirectoryData = _loadDirectoryData

    det.subspace, det.getdata = sub, gd
    return {"detex": det, "detex.subspace": sub, "detex.getdata": gd}


def _ref_fetcher(mods, conDir):
    gd = mods["detex.getdata"]
    f = gd.DataFetcher.__new__(gd.DataFetcher)
    f.__dict__.update(dict(
        method="dir", client=None, removeResponse=False, inventoryArg=None,
        directoryName=conDir, opType="VEL", prefilt=[0.05, 0.1, 15, 20],
        conDatDuration=3600, conBuff=120, timeBeforeOrigin=60,
        timeAfterOrigin=240, checkData=True, fillZeros=False,
        _getStream=gd._loadDirectoryData))
    return f


def _reference_cluster(clust, mods, conDir):
    sub = mods["detex.subspace"]
    rcs = sub.ClusterStream.__new__(sub.ClusterStream)
    rcs.__dict__.update(dict(
        trdf=clust.trdf, temkey=clust.temkey, stakey=clust.stakey,
        fetcher=_ref_fetcher(mods, conDir), eventList=clust.eventList,
        ccReq=None, filt=clust.filt, decimate=clust.decimate,
        trim=clust.trim, fileName=clust.filename, filename=clust.filename,
        eventsOnAllStations=False, enforceOrigin=False,
        stalist=clust.stalist, stalist2=clust.stalist2))
    rcs.self = rcs  # the reference's locals()-update quirk
    rclusters = []
    for c in clust.clusters:
        rc = sub.Cluster.__new__(sub.Cluster)
        rc.__dict__.update(dict(
            link=c.link, DFcc=c.DFcc, station=c.station, temkey=c.temkey,
            key=list(c.key), trim=c.trim, decimate=c.decimate,
            nonClustColor="0.6", ccReq=c.ccReq, clusts=c.clusts,
            singles=c.singles, clustcount=c.clustcount))
        rclusters.append(rc)
    rcs.clusters = rclusters
    return rcs


def _dump(obj_fn, path):
    """Pickle what ``obj_fn(mods)`` makes while the stand-in modules are
    registered, at protocol 2."""
    mods = _fake_detex_modules()
    sys.modules.update(mods)
    try:
        with open(path, "wb") as fh:
            pickle.dump(obj_fn(mods), fh, protocol=2)
    finally:
        for k in mods:
            sys.modules.pop(k, None)


@pytest.fixture(scope="module")
def built(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("tmigrate")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        clust = jcon.createCluster(
            CCreq=0.5, fetch_arg=synth_case["eventDir"],
            filt=[1, 8, 2, True], stationKey=synth_case["stationKey"],
            templateKey=synth_case["templateKey"], trim=[10, 60],
            saveclust=False)
        clust.updateReqCC({"TA.S00": 0.5, "TA.S01": 0.6})
        cf = jget.DataFetcher("dir", directoryName=synth_case["conDir"])
        ss = jcon.createSubSpace(Pf=1e-9, clust=clust, conDatFetcher=cf)
        ss.attachPickTimes(pksFile=synth_case["phaseKey"],
                           defaultDuration=20)
        ss.SVD(selectCriteria=2, selectValue=0.9, threshold=0.5,
               useSingles=True)
    finally:
        os.chdir(cwd)
    con = synth_case["conDir"]
    cpath, spath = str(wd / "ref_clust.pkl"), str(wd / "ref_ss.pkl")
    _dump(lambda mods: _reference_cluster(clust, mods, con), cpath)

    def reference_subspace(mods):
        rss = mods["detex.subspace"].SubSpace.__new__(
            mods["detex.subspace"].SubSpace)
        rss.__dict__.update(dict(
            cfetcher=_ref_fetcher(mods, con),
            clusters=_reference_cluster(clust, mods, con),
            subspaces=ss.subspaces, singles=ss.singles,
            singletons=ss.singles, dtype=ss.dtype, Pf=ss.Pf,
            ssStations=ss.ssStations, singStations=ss.singStations,
            Stations=ss.Stations))
        return rss
    _dump(reference_subspace, spath)
    return dict(clust=clust, ss=ss, cpath=cpath, spath=spath, wd=wd)


def test_detex_cluster_stream_migrates_as_in_jax(built, synth_case):
    with pytest.raises((ModuleNotFoundError, ImportError)):
        with open(built["cpath"], "rb") as fh:
            pickle.load(fh)
    got = tutil.loadClusters(built["cpath"], device="cpu")
    want = jutil.loadClusters(built["cpath"])
    assert isinstance(got, ClusterStream) and got.device == "cpu"
    assert got.stalist == want.stalist
    assert got.filt == list(want.filt) and got.trim == list(want.trim)
    for a, b in zip(got.clusters, want.clusters):
        assert (a.station, a.key, a.ccReq) == (b.station, b.key, b.ccReq)
        assert a.clusts == b.clusts and a.singles == b.singles
        m = len(b.key)
        np.testing.assert_array_equal(
            a.CCs, jcon._square_from_df(b.DFcc, m))
        row = got.row(a.station)
        jrow = want.trdf[want.trdf.Station == a.station].iloc[0]
        np.testing.assert_array_equal(
            row["Lags"], jcon._square_from_df(jrow.Lags, m, fill=0.0))
        np.testing.assert_array_equal(
            row["Subsamp"], jcon._square_from_df(jrow.Subsamp, m))
        for ev in b.key:
            np.testing.assert_array_equal(row["MPtd"][ev], jrow.MPtd[ev])
    assert got.fetcher.method == "dir" and got.fetcher.conBuff == 120
    assert [r["NAME"] for r in got.temkey] == list(want.temkey.NAME)
    got.updateReqCC(0.98)
    want.updateReqCC(0.98)
    assert [c.clusts for c in got.clusters] == \
        [c.clusts for c in want.clusters]
    # the raw template streams were fetched again: createSubSpace runs
    got.updateReqCC(0.5)
    want.updateReqCC(0.5)
    cf = synth_case["conDir"]
    tss = detex_torch.createSubSpace(Pf=1e-9, clust=got, conDatFetcher=cf,
                                     device="cpu")
    jss = jcon.createSubSpace(Pf=1e-9, clust=want, conDatFetcher=cf)
    for sta, rows in tss.subspaces.items():
        jrows = jss.subspaces[sta]
        assert [(r["Name"], r["Events"]) for r in rows] == \
            list(zip(jrows.Name, jrows.Events))
    assert {s: [r["Events"] for r in v] for s, v in tss.singles.items()} \
        == {s: list(v.Events) for s, v in jss.singles.items()}


def test_detex_subspace_migrates_and_detects(built, tmp_path):
    got = tutil.loadSubSpace(built["spath"], device="cpu")
    ss = built["ss"]
    assert isinstance(got, SubSpace) and got.device == "cpu"
    assert got.ssStations == ss.ssStations and got.Pf == ss.Pf
    assert got.dtype == ss.dtype and got.conBuff == 120
    for frames, jframes in ((got.subspaces, ss.subspaces),
                            (got.singles, ss.singles)):
        for sta, rows in frames.items():
            jrows = list(jframes[sta].iterrows())
            assert len(rows) == len(jrows)
            for r, (_, j) in zip(rows, jrows):
                assert (r["Name"], r["Events"]) == (j.Name, list(j.Events))
                assert r["SampleTrims"] == j.SampleTrims
                assert r["Threshold"] == j.Threshold
                assert list(r["Offsets"]) == list(j.Offsets)
                if "SVD" in j:
                    assert r["UsedSVDKeys"] == j.UsedSVDKeys
                    assert r["SVDdefined"] and r["NumBasis"] == j.NumBasis
    t0 = np.floor(min(UTCDateTime(x).timestamp
                      for x in ss.clusters.temkey.TIME) / 3600.0) * 3600.0
    kw = dict(utcStart=t0, utcEnd=t0 + 5 * 3600.0, useSingles=True,
              batchSize=1, estimateMags=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DETEX_TPU_MESH", "0")
        ss.detex(subspaceDB=str(tmp_path / "native.db"), **kw)
    got.detex(subspaceDB=str(tmp_path / "migrated.db"), **kw)
    for table in ("ss_df", "sg_df"):
        rows = tutil.loadSQLite(str(tmp_path / "migrated.db"), table)
        want = jutil.loadSQLite(str(tmp_path / "native.db"),
                                table).to_dict("records")
        assert len(rows) == len(want) > 0, table
        for g, w in zip(rows, want):
            assert (g["Sta"], g["Name"], g["STMP"]) == \
                (w["Sta"], w["Name"], w["STMP"])
            assert abs(g["DS"] - w["DS"]) <= 1e-6


def test_unpickler_shells_placeholders_and_refusals(built):
    shell = migrate.load_reference_pickle(built["cpath"])
    assert isinstance(shell, migrate._ShellClusterStream)
    with pytest.raises(NotImplementedError):
        shell.fetcher._getStream()
    for bad, exc in ((b"cos\nsystem\n(S'true'\ntR.", pickle.UnpicklingError),
                     (b"cbuiltins\neval\n(S'1+1'\ntR.",
                      pickle.UnpicklingError),
                     (b"\x80\x02cdetex_tpu.subspace\nSubSpace\nq\x00)"
                      b"\x81q\x01.", NotImplementedError)):
        with pytest.raises(exc):
            migrate._DetexUnpickler(io.BytesIO(bad)).load()
    with pytest.raises(NotImplementedError, match="migrate"):
        tutil.readRows(built["spath"])
    with pytest.raises(TypeError):
        tutil.loadSubSpace(built["cpath"], device="cpu")
    empty = str(built["wd"] / "empty.pkl")
    with open(empty, "wb") as fh:
        fh.write(b"\x80\x02cdetex.subspace\nSubSpace\nq\x00)\x81q\x01.")
    with pytest.raises(NotImplementedError, match="migrate"):
        tutil.loadSubSpace(empty, device="cpu")
