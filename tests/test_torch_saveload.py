"""Saved objects of detex_torch on the CPU: ClusterStream and SubSpace
through write -> util.loadClusters / loadSubSpace, createSubSpace from a
pickled cluster's path, the state a pickle holds, the refusal of
detex_tpu, Detex and pandas pickles, and writeSimpleHypoDDInput against
detex_tpu's.

Both packages build from the ``synth_case`` key files (tests/conftest.py)
with enforceOrigin=True, each writing its cluster pickle
(saveclust=True). Round trips are held exactly: every row, matrix,
waveform and cluster of the loaded object equals the written one, and the
loaded SubSpace's detections are the original's row for row, every column
equal. The refusal runs in a fresh process, which must end without
detex_tpu, jax or pandas imported. The dt.cc file is held byte for byte
against detex_tpu's on the same CC, lag and subsample matrices
(detex_tpu's, set into the port's cluster), and on the port's own
matrices the same pairs and stations with lags and CCs within 1e-3.
"""
import os
import pickle
import pickletools
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from detex_tpu import construct as jcon
import detex_torch
from detex_torch import util as tutil
from detex_torch.core.utc import UTCDateTime
from detex_torch.data import fetcher as tget

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def objs(synth_case, tmp_path_factory):
    wd = tmp_path_factory.mktemp("tsaveload")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        kw = dict(CCreq=0.5, fetch_arg=synth_case["eventDir"],
                  filt=[1, 8, 2, True], stationKey=synth_case["stationKey"],
                  templateKey=synth_case["templateKey"], trim=[10, 60],
                  dtype="double", enforceOrigin=True, saveclust=True)
        jcl = jcon.createCluster(fileName=str(wd / "jclust.pkl"), **kw)
        tcl = detex_torch.createCluster(fileName=str(wd / "tclust.pkl"),
                                        device="cpu", **kw)
        cf = tget.DataFetcher("dir", directoryName=synth_case["conDir"])
        ss = detex_torch.createSubSpace(Pf=1e-9, clust=tcl, conDatFetcher=cf,
                                        device="cpu")
        ss.attachPickTimes(pksFile=synth_case["phaseKey"],
                           defaultDuration=20)
        ss.SVD(selectCriteria=2, selectValue=0.9, threshold=0.5,
               useSingles=True)
    finally:
        os.chdir(cwd)
    return dict(wd=wd, jcl=jcl, tcl=tcl, ss=ss, cf=cf)


def _equal(a, b, path="obj"):
    """Deep equality of saved state: arrays bit for bit (NaN equal),
    dicts, lists and the port's objects member by member."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=np.asarray(a).dtype.kind == "f"), \
            path
    elif isinstance(a, dict):
        assert type(a) is type(b) and list(a) == list(b), path
        for k in a:
            _equal(a[k], b[k], "%s[%r]" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, "%s[%d]" % (path, i))
    elif type(a).__module__.startswith("detex_torch") and \
            hasattr(a, "__dict__"):
        assert type(a) is type(b), path
        _equal(vars(a), vars(b), path)
    elif isinstance(a, float) and a != a:
        assert isinstance(b, float) and b != b, path
    else:
        assert a == b, (path, a, b)


def test_cluster_stream_round_trip(objs):
    tcl = objs["tcl"]
    path = str(objs["wd"] / "tclust.pkl")
    assert os.path.exists(path)           # createCluster(saveclust=True)
    back = tutil.loadClusters(path, device="cpu")
    assert back.device == "cpu" and back is not tcl
    _equal(vars(back), vars(tcl))
    assert [c.clusts for c in back.clusters] == \
        [c.clusts for c in tcl.clusters]
    # write() again to the same name, and the Cluster writer
    tcl.write()
    _equal(vars(tutil.loadClusters(path, device="cpu")), vars(tcl))
    cwd = os.getcwd()
    os.chdir(objs["wd"])
    try:
        tcl.clusters[0].write()
        with open("clust.pkl", "rb") as fh:
            cl0 = tutil.RestrictedUnpickler(fh).load()
    finally:
        os.chdir(cwd)
    _equal(vars(cl0), vars(tcl.clusters[0]))
    with pytest.raises(TypeError):
        tutil.loadSubSpace(path, device="cpu")


def test_create_subspace_from_a_path_equals_in_memory(objs):
    path = str(objs["wd"] / "tclust.pkl")
    a = detex_torch.createSubSpace(Pf=1e-9, clust=path,
                                   conDatFetcher=objs["cf"], device="cpu")
    b = detex_torch.createSubSpace(Pf=1e-9, clust=objs["tcl"],
                                   conDatFetcher=objs["cf"], device="cpu")
    assert a.clusters is not b.clusters and a.device == "cpu"
    _equal(a.subspaces, b.subspaces)
    _equal(a.singles, b.singles)
    assert sum(len(v) for v in a.subspaces.values()) == 4


def test_subspace_round_trip_and_detex_rows(objs, tmp_path):
    ss = objs["ss"]
    path = str(tmp_path / "subspace.pkl")
    ss.write(path)
    back = tutil.loadSubSpace(path, device="cpu")
    _equal(back.subspaces, ss.subspaces)
    _equal(back.singles, ss.singles)
    assert back.Pf == ss.Pf and back.dtype == ss.dtype
    t0 = np.floor(min(UTCDateTime(x["TIME"]).timestamp
                      for x in ss.clusters.temkey) / 3600.0) * 3600.0
    tables = []
    for obj, db in ((ss, "a.db"), (back, "b.db")):
        obj.detex(utcStart=t0, utcEnd=t0 + 5 * 3600.0,
                  subspaceDB=str(tmp_path / db), useSingles=True)
        tables.append({t: tutil.loadSQLite(str(tmp_path / db), t)
                       for t in ("ss_df", "sg_df", "ss_info", "ss_hist")})
    for t in tables[0]:
        assert tables[0][t], t
        _equal(tables[1][t], tables[0][t], t)


def test_pickle_holds_no_tensor_and_no_callable(objs, tmp_path):
    """A tensor in a saved SubSpace is numpy in the pickle (no torch name
    in it, so it loads without a card) and a tensor again on the loader's
    device; the caller's null-chunk callable is not kept."""
    ss = objs["ss"]
    sta = ss.ssStations[0]
    row = ss.subspaces[sta][0]
    row["Extra"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ss._fasChunks = lambda sta: iter(())
    saved_device = ss.device
    ss.device = torch.device("cpu")
    try:
        path = str(tmp_path / "ss.pkl")
        ss.write(path)
        with open(path, "rb") as fh:
            data = fh.read()
        names = [arg for op, arg, _ in pickletools.genops(data)
                 if op.name in ("GLOBAL", "SHORT_BINUNICODE", "BINUNICODE",
                                "UNICODE") and isinstance(arg, str)]
        assert not any(n.startswith("torch") for n in names)
        assert "detex_torch.util" in names and "HostTensor" in names
        back = tutil.loadSubSpace(path, device="cpu")
    finally:
        del row["Extra"]
        ss._fasChunks = None
        ss.device = saved_device
    got = back.subspaces[sta][0]["Extra"]
    assert torch.is_tensor(got) and got.device.type == "cpu"
    assert torch.equal(got, torch.arange(6, dtype=torch.float32).reshape(
        2, 3))
    assert back._fasChunks is None and back.device == "cpu"
    assert "Extra" not in ss.subspaces[sta][0]


def test_foreign_pickles_refused_without_importing_them(objs, tmp_path):
    """detex_tpu's own cluster pickle, a pickled DataFrame (what
    detex_tpu's EventCors and UTCsaves tables are) and a Detex class name
    raise NotImplementedError in a fresh process, which never imports
    detex_tpu, jax or pandas; a name outside the allowed modules raises
    UnpicklingError."""
    jpath = str(objs["wd"] / "jclust.pkl")
    assert os.path.exists(jpath)
    dfpath = str(tmp_path / "EventCors_XX.S1.pkl")
    pd.DataFrame([["XX.S1", "SS0", 0.5, 1e9]],
                 columns=["Sta", "Name", "DS", "TimeStamp"]).to_pickle(
        dfpath)
    detex_path = str(tmp_path / "old.pkl")
    with open(detex_path, "wb") as fh:
        fh.write(b"\x80\x02cdetex.subspace\nSubSpace\nq\x00)\x81q\x01.")
    other = str(tmp_path / "other.pkl")
    with open(other, "wb") as fh:
        pickle.dump(os.path.join, fh)   # names posixpath.join
    code = (
        "import pickle, sys\n"
        "from detex_torch import util\n"
        "for fn, p in ((util.loadClusters, %r), (util.readRows, %r),\n"
        "              (util.loadSubSpace, %r)):\n"
        "    try:\n"
        "        fn(p) if fn is util.readRows else fn(p, device='cpu')\n"
        "    except NotImplementedError as e:\n"
        "        assert 'migrate' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('not refused: ' + p)\n"
        "try:\n"
        "    util.readRows(%r)\n"
        "except pickle.UnpicklingError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('not refused: other')\n"
        "bad = [m for m in ('detex_tpu', 'jax', 'pandas')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (jpath, dfpath, detex_path, other))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert proc.stdout.strip().endswith("ok")


def test_write_simple_hypodd_input_matches_jax(objs, tmp_path):
    jcl, tcl = objs["jcl"], objs["tcl"]
    jpath, tpath = str(tmp_path / "j.cc"), str(tmp_path / "t.cc")
    jcl.writeSimpleHypoDDInput(jpath, minCC=0.3)
    tcl.writeSimpleHypoDDInput(tpath, minCC=0.3)
    with open(jpath) as fh:
        want = fh.read()
    with open(tpath) as fh:
        own = fh.read()
    assert want.count("#") >= 4
    # the port's own matrices: the same pairs and stations, values close
    wl, gl = want.splitlines(), own.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if w.startswith("#"):
            assert g == w
        else:
            gs, ws = g.split(), w.split()
            assert gs[0] == ws[0] and gs[3] == ws[3] == "S"
            assert abs(float(gs[1]) - float(ws[1])) <= 1e-3
            assert abs(float(gs[2]) - float(ws[2])) <= 1e-3
    # detex_tpu's matrices in the port's cluster: byte for byte
    saved = [{k: r[k] for k in ("CCs", "Lags", "Subsamp")}
             for r in tcl.trdf]
    try:
        for r in tcl.trdf:
            jrow = jcl.trdf[jcl.trdf.Station == r["Station"]].iloc[0]
            m = len(r["Events"])
            r["CCs"] = jcon._square_from_df(jrow.CCs, m)
            r["Lags"] = jcon._square_from_df(jrow.Lags, m, fill=0.0)
            r["Subsamp"] = jcon._square_from_df(jrow.Subsamp, m, fill=0.0)
        for kw in (dict(), dict(coef=2, minCC=0.6)):
            jcl.writeSimpleHypoDDInput(jpath, **kw)
            tcl.writeSimpleHypoDDInput(tpath, **kw)
            with open(jpath, "rb") as a, open(tpath, "rb") as b:
                assert a.read() == b.read()
    finally:
        for r, s in zip(tcl.trdf, saved):
            r.update(s)
    tcl.enforceOrigin = False
    try:
        with pytest.raises(detex_torch.DetexError):
            tcl.writeSimpleHypoDDInput(tpath)
    finally:
        tcl.enforceOrigin = True


def test_unpickler_admits_types_not_callables(tmp_path):
    """builtins' types and numpy load; builtins.eval, os.system and the
    like raise UnpicklingError before anything is called."""
    import io
    ok = {"a": {1, 2}, "b": frozenset("xy"), "c": complex(1, 2),
          "d": np.arange(4.0), "e": slice(1, 3)}
    got = tutil.RestrictedUnpickler(io.BytesIO(pickle.dumps(ok))).load()
    assert got["a"] == ok["a"] and got["e"] == ok["e"]
    assert np.array_equal(got["d"], ok["d"])
    for bad in (b"cbuiltins\neval\n(S'1+1'\ntR.",
                b"cos\nsystem\n(S'true'\ntR.",
                pickle.dumps(os.path.join)):
        with pytest.raises(pickle.UnpicklingError):
            tutil.RestrictedUnpickler(io.BytesIO(bad)).load()


def test_get_number_channels_matches_jax():
    from detex_tpu import util as jutil
    from detex_tpu.core import Stream as JStream
    from detex_tpu.core import Trace as JTrace
    from detex_torch.core import Stream, Trace
    for mods in ((Stream, Trace, tutil), (JStream, JTrace, jutil)):
        S, T, u = mods
        st = S([T(np.zeros(10), dict(network="XX", station="S1",
                                     channel=c)) for c in ("BHZ", "BHN",
                                                           "BHZ")])
        assert u.get_number_channels(st) == 2
        st = S([T(np.zeros(10), dict(network="XX", station=s,
                                     channel="BHZ")) for s in ("S1", "S2")])
        with pytest.raises(Exception):
            u.get_number_channels(st)
