"""The synthetic Case1 pipeline through detex_torch's key-file entry points
on the CPU, against detex_tpu's, and the recorded reference the card is
held against.

One module fixture runs scripts/record_case1_reference.py's record():
detex_tpu's pipeline (tests/test_pipeline.py's calls at the
``synth_case`` parameters, in the environment the script pins) at dtype
"double" and "single". The port runs the same pipeline from its own
SynthCatalog through chip_smoke.case1_run (phase H1's code) with
device="cpu" at "double": createCluster(fetch_arg=..., stationKey=...,
templateKey=...) -> createSubSpace(conDatFetcher=DataFetcher("dir")) ->
attachPickTimes -> SVD with FAS -> detex -> detResults, with no dict or
callable from the caller.

Tolerances are tests/test_torch_construct.py's: clusters, singles, lags,
alignment delays, SampleTrims and NumBasis identical; AlignedTD 1e-12
relative; Offsets 1e-9; thresholds 1e-5 relative; the ss_df / sg_df rows
in the same order with STMP exact, DS within 1e-6 at dtype "double"
(tests/test_torch_detect.py's). detResults is held exactly on one
database (detex_tpu's): the port's Dets / Autos / Vers equal detex_tpu's
row for row. On each package's own database the events, their station
counts, windows and verification are identical and the DS averages within
the rows' 1e-6. The regenerated record equals the committed
tests/data/case1_reference.json text for text, and phase H1's gate
(chip_smoke.case1_hold) passes on the port's CPU run against it.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from detex_tpu import results as jres
from detex_torch import results as tres
from test_torch_results import _same_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def _recorder():
    spec = importlib.util.spec_from_file_location(
        "record_case1_reference",
        os.path.join(REPO, "scripts", "record_case1_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rec_mod = _recorder()
    wd = tmp_path_factory.mktemp("tpipeline")
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        fixture, jobjs = rec_mod.record(str(wd / "jax"))
        trec, tobjs, _ = cs.case1_run(fixture["params"], "double",
                                      str(wd / "torch"), "cpu")
    finally:
        os.chdir(cwd)
    with open(cs.CASE1_FIXTURE) as fh:
        committed = fh.read()
    return dict(fixture=fixture, jobjs=jobjs["double"], trec=trec,
                tobjs=tobjs, committed=committed, rec_mod=rec_mod)


def test_reference_record_regenerates(case):
    """The committed fixture is what detex_tpu gives today, text for
    text; its environment and parameters are the script's."""
    assert case["rec_mod"].dumps(case["fixture"]) == case["committed"]
    saved = json.loads(case["committed"])
    assert saved["env"] == case["rec_mod"].ENV
    for dtype in ("double", "single"):
        assert len(saved[dtype]["results"]["Vers"]) == \
            len(saved[dtype]["hidden"]) == 2


def test_case1_clusters_lags_and_delays(case):
    want = case["fixture"]["double"]
    got = case["trec"]
    assert got["hidden"] == want["hidden"]
    assert got["clusters"] == want["clusters"]
    assert got["lags"] == want["lags"]
    assert got["delays"] == want["delays"]
    for sta, cl in got["clusters"].items():
        assert len(cl["clusts"]) == 2 and len(cl["singles"]) == 1


def _row_pairs(case):
    jss, tss = case["jobjs"]["ss"], case["tobjs"]["ss"]
    for frames_j, frames_t in ((jss.subspaces, tss.subspaces),
                               (jss.singles, tss.singles)):
        assert sorted(frames_j) == sorted(frames_t)
        for sta in sorted(frames_j):
            assert len(frames_j[sta]) == len(frames_t[sta])
            for (_, jr), tr in zip(frames_j[sta].iterrows(), frames_t[sta]):
                assert tr["Name"] == jr.Name
                assert tr["Events"] == list(jr.Events)
                yield jr, tr


def test_case1_detectors_trims_and_thresholds(case):
    n = 0
    for jr, tr in _row_pairs(case):
        n += 1
        assert tr["SampleTrims"] == jr.SampleTrims
        np.testing.assert_allclose(np.asarray(tr["Offsets"], float),
                                   np.asarray(jr.Offsets, float), rtol=0,
                                   atol=1e-9)
        wfs_t = tr.get("AlignedTD") or tr["MPtd"]
        wfs_j = jr.AlignedTD if "AlignedTD" in tr else jr.MPtd
        assert list(wfs_t) == list(wfs_j)
        for e in wfs_j:
            scale = np.abs(wfs_j[e]).max()
            assert np.abs(wfs_t[e] - wfs_j[e]).max() <= 1e-12 * scale
        if "NumBasis" in tr:
            assert tr["NumBasis"] == jr.NumBasis
        np.testing.assert_allclose(tr["Threshold"], jr.Threshold, rtol=1e-5)
    assert n == 6
    for sta, dets in case["fixture"]["double"]["detectors"].items():
        got = case["trec"]["detectors"][sta]
        assert [(d["kind"], d["Name"], d["Events"], d["NumBasis"])
                for d in got] == [(d["kind"], d["Name"], d["Events"],
                                   d["NumBasis"]) for d in dets]


def test_case1_detection_rows(case):
    want = case["fixture"]["double"]["rows"]
    got = case["trec"]["rows"]
    for table in ("ss_df", "sg_df"):
        assert len(got[table]) == len(want[table]) > 0
        assert [r[:3] for r in got[table]] == [r[:3] for r in want[table]]
        ds = np.abs(np.array([r[3] for r in got[table]]) -
                    np.array([r[3] for r in want[table]]))
        assert ds.max() <= 1e-6


def test_case1_det_results(case):
    """detResults of both packages on detex_tpu's database: equal row for
    row. On each package's own database: the same events, station counts,
    windows and verifications, DS averages within 1e-6."""
    jp, jdb = case["jobjs"]["paths"], case["jobjs"]["db"]
    kw = dict(case["fixture"]["params"]["detResults"],
              templateKey=jp["templateKey"], stationKey=jp["stationKey"],
              veriFile=jp["veriFile"], fetch=jp["conDir"])
    got = tres.detResults(ssDB=jdb, **kw)
    want = jres.detResults(ssDB=jdb, **kw)
    _same_table(got.Dets, want.Dets)
    _same_table(got.Autos, want.Autos)
    _same_table(got.Vers, want.Vers, columns_in_order=False)
    fx, tr = case["fixture"]["double"]["results"], case["trec"]["results"]
    for name in ("Dets", "Autos", "Vers"):
        assert len(tr[name]) == len(fx[name]) > 0
        for a, b in zip(tr[name], fx[name]):
            assert a[:3] == b[:3] and a[4] == b[4]
            assert abs(a[3] - b[3]) <= 1e-6
    res_t, res_j = case["tobjs"]["res"], case["jobjs"]["res"]
    assert [r["Verified"] for r in res_t.Dets] == list(res_j.Dets.Verified)
    assert [r["VerName"] for r in res_t.Vers] == list(res_j.Vers.VerName)


def test_case1_phase_h1_gate_on_the_cpu(case):
    """Phase H1's gate (chip_smoke.case1_hold) on the port's CPU run
    against the committed record of dtype "double"."""
    saved = json.loads(case["committed"])
    th_err, ds_err, ties = cs.case1_hold("cpu double", case["trec"],
                                         saved["double"], case["tobjs"])
    assert ties == 0 and th_err <= 1e-5 and ds_err <= 1e-6
