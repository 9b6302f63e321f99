"""The detection engine and serving of detex_torch on a mesh, and
serving.export_detectors, held against detex_tpu on the CPU.

The SubSpace is detex_tpu's, built from the synthetic Case1 analog (the
``synth_case`` fixture of tests/conftest.py) as tests/test_torch_detect.py
builds it, and the port's engine reads its detectors and chunks through
that file's adapters. detex_tpu runs its engine sharded over the 8 virtual
CPU devices tests/conftest.py gives it (its default: DETEX_TPU_MESH
unset); the port's engine is handed an 8-entry CPU mesh by replacing
parallel/scan.engine_mesh (what it returns with several CUDA devices).

- Engine: the port's rows on the mesh equal its rows without one, column
  for column (NaN where NaN), and so do the histograms; against
  detex_tpu's sharded engine the rows are the same in number, detector,
  station and STMP (within 1e-7), DS within 2e-5 and magnitudes within
  1e-5, as tests/test_torch_detect.py holds the unsharded engines, and
  every histogram total is exact. A batch of 8 and an odd batch of 5
  (padded to 8 on the mesh).
- Serving: export_detectors of the same detectors written by both
  packages gives the same npz, array for array (the float32 U bit for
  bit), with ``meta`` parsing equal; the port's artifact round-trips
  through load_detectors and scan_station, on a mesh and without one.
"""
import json
import os
import types

import numpy as np
import pytest

from detex_tpu import serving as jserving
from detex_tpu import util
from detex_tpu.construct import _applyFilter, multiplex
from detex_torch import detect as tdetect
from detex_torch import serving as tserving
from detex_torch import subspace as tsubspace
from detex_torch import util as tutil
from detex_torch.parallel import mesh as tmesh
from detex_torch.parallel import scan as tscan
from test_torch_detect import SPAN, _chunks, _stations, _subspace, _window


@pytest.fixture(scope="module")
def ss(synth_case, tmp_path_factory):
    return _subspace(synth_case, tmp_path_factory.mktemp("tmesh_engine"))


def _cpu_mesh(n=8):
    return tmesh.make_mesh(devices=["cpu"] * n)


def _sorted_rows(cols):
    keys = ("Sta", "Name", "STMP")
    order = sorted(range(len(cols["STMP"])), key=lambda i: tuple(
        str(cols[k][i]) if k != "STMP" else float(cols[k][i]) for k in keys))
    return {k: [v[i] for i in order] for k, v in cols.items()}


def _close(g, w, atol):
    g = np.asarray(g, np.float64)
    w = np.asarray(w, np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    assert np.abs(g[m] - w[m]).max(initial=0.0) <= atol


@pytest.mark.parametrize("batch", [8, 5])
def test_engine_rows_on_a_mesh(ss, tmp_path, monkeypatch, batch):
    utc0, utc1 = _window(ss, SPAN)
    mags = batch == 8
    kw = dict(conDatDuration=ss.cfetcher.conDatDuration,
              conBuff=ss.cfetcher.conBuff, filt=ss.clusters.filt,
              decimate=ss.clusters.decimate, issubspace=True,
              dtype="single", batchSize=batch, estimateMags=mags,
              device="cpu")

    def run(name, mesh):
        monkeypatch.setattr(tscan, "engine_mesh", lambda device=None: mesh)
        tscan.ROUTE_COUNTS.clear()
        db = str(tmp_path / name)
        hist = tdetect.detex(_stations(ss, True), _chunks(ss, utc0, utc1),
                             subspaceDB=db, **kw)
        return (tutil.loadSQLite(db, "ss_df", columns=True), hist,
                dict(tscan.ROUTE_COUNTS))

    one, hist_1, routes_1 = run("one.db", None)
    got, hist_m, routes_m = run("mesh.db", _cpu_mesh())
    assert not any("+sharded" in r for r in routes_1)
    assert routes_m and all("+sharded" in r for r in routes_m
                            if not r.startswith("dense"))
    assert got is not None and len(got["STMP"]) > 0
    assert sorted(got) == sorted(one)
    for col in got:
        a, b = np.asarray(got[col]), np.asarray(one[col])
        if a.dtype.kind == "f":
            assert np.array_equal(a, b, equal_nan=True), col
        else:
            assert list(a) == list(b), col
    for sta in hist_1:
        if sta == "Bins":
            continue
        for name, counts in hist_1[sta].items():
            assert np.array_equal(hist_m[sta][name], counts)

    monkeypatch.delenv("DETEX_TPU_MESH", raising=False)
    db_j = str(tmp_path / "jax.db")
    saved = ss.dtype
    ss.dtype = "single"
    try:
        ss.detex(utcStart=utc0, utcEnd=utc1, subspaceDB=db_j,
                 useSubSpaces=True, useSingles=False, batchSize=batch,
                 estimateMags=mags)
    finally:
        ss.dtype = saved
    want = util.loadSQLite(db_j, "ss_df")
    want = _sorted_rows({c: list(want[c]) for c in want.columns})
    got = _sorted_rows(got)
    assert len(got["STMP"]) == len(want["STMP"])
    assert [str(x) for x in got["Name"]] == [str(x) for x in want["Name"]]
    assert list(got["Sta"]) == list(want["Sta"])
    for col in ("STMP", "MSTAMPmin", "MSTAMPmax"):
        _close(got[col], want[col], 1e-7)
    _close(got["DS"], want["DS"], 2e-5)
    if mags:
        for col in ("Mag", "SNR", "ProEnMag"):
            _close(got[col], np.asarray(want[col], np.float64), 1e-5)
    for sta, dets in ss.histSubSpaces.items():
        if sta == "Bins":
            continue
        for name, counts in dets.items():
            assert hist_m[sta][name].sum() == counts.sum(), (sta, name)


def _port_subspace(ss):
    """The port's SubSpace holding detex_tpu's detectors: every frame row
    as a dict, the clusters' filt and decimate."""
    def rows(frames):
        return {sta: [row.to_dict() for _, row in df.iterrows()]
                for sta, df in frames.items()}
    cl = types.SimpleNamespace(filt=ss.clusters.filt,
                               decimate=ss.clusters.decimate)
    return tsubspace.SubSpace(rows(ss.singles), rows(ss.subspaces), cl,
                              ss.dtype, ss.Pf, 3600.0, 120.0, "cpu")


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("useSingles", [True, False])
def test_export_detectors_matches_jax(ss, tmp_path, useSingles):
    """export_detectors of the same detectors: the same array names, U
    bit for bit (float32), meta equal once parsed."""
    pj = jserving.export_detectors(ss, str(tmp_path / "j.npz"), useSingles)
    pt = tserving.export_detectors(_port_subspace(ss),
                                   str(tmp_path / "t.npz"), useSingles)
    zj, zt = _npz(pj), _npz(pt)
    assert sorted(zt) == sorted(zj)
    assert json.loads(str(zt["meta"])) == json.loads(str(zj["meta"]))
    kinds = {d["kind"] for s in json.loads(str(zt["meta"]))[
        "stations"].values() for d in s["detectors"]}
    assert kinds == ({"ss", "sg"} if useSingles else {"ss"})
    for k in zj:
        if k != "meta":
            assert zt[k].dtype == np.float32
            assert np.array_equal(zt[k], zj[k]), k


def test_export_load_and_scan_on_a_mesh(ss, synth_case, tmp_path):
    """The port's artifact loads (load_detectors) and scan_station over an
    8-entry mesh of 8 hour chunks equals the scan without a mesh
    (histograms, trigger counts and indices exact, maxima within 1e-6)
    and finds what detex_tpu's sharded serving scan of its own artifact
    finds (trigger counts exact, maxima within 2e-5: detex_tpu builds
    full-length banks on the CPU, the port overlap-save ones, ROADMAP
    C30)."""
    from detex_tpu.parallel import mesh as jmesh
    path = tserving.export_detectors(_port_subspace(ss),
                                     str(tmp_path / "t.npz"))
    dep = tserving.load_detectors(path, chunk_sec=3600, conBuff=120,
                                  device="cpu")
    cat, fet = synth_case["cat"], ss.cfetcher
    chunks = []
    for h in range(8):
        s = cat.t0 + h * 3600.0
        st = fet.getStream(s, s + 3720, "TA", "S00", ["BHE", "BHN", "BHZ"],
                           "*")
        chunks.append(multiplex(_applyFilter(st, [1, 8, 2, True]), 3))
    L = min(len(c) for c in chunks)
    X = np.stack([c[:L] for c in chunks]).astype(np.float32)
    tscan.ROUTE_COUNTS.clear()
    res_m = tserving.scan_station(dep, "TA.S00", X, mesh=_cpu_mesh())
    assert all(r.endswith("+sharded") for r in tscan.ROUTE_COUNTS)
    res_1 = tserving.scan_station(dep, "TA.S00", X)
    jdep = jserving.load_detectors(jserving.export_detectors(
        ss, str(tmp_path / "j.npz")), chunk_sec=3600, conBuff=120)
    res_j = jserving.scan_station(jdep, "TA.S00", X,
                                  mesh=jmesh.make_mesh(8))
    assert sum(int(r["trig_count"].sum()) for r in res_m) > 0
    by_name_j = {}
    for r in res_j:
        for s, name in enumerate(r["names"]):
            by_name_j[name] = (r["maxds"][:, s], r["trig_count"][:, s])
    for rm, r1 in zip(res_m, res_1):
        assert rm["names"] == r1["names"]
        assert np.array_equal(rm["hist"], r1["hist"])
        assert np.array_equal(rm["trig_count"], r1["trig_count"])
        assert np.array_equal(rm["trig_idx"], r1["trig_idx"])
        assert np.abs(rm["maxds"] - r1["maxds"]).max() <= 1e-6
        for s, name in enumerate(rm["names"]):
            mj, cj = by_name_j[name]
            assert np.abs(rm["maxds"][:, s] - mj).max() <= 2e-5
            assert np.array_equal(rm["trig_count"][:, s], cj)
