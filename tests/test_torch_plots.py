"""The construction plots and printers of detex_torch on the CPU against
detex_tpu's: Cluster / ClusterStream.simMatrix, dendro, plotEvents and
printAtr; SubSpace.plotThresholds, plotFracEnergy, plotAlignedEvents,
plotBasisVectors, plotOffsetTimes and printOffsets.

Both packages build from the ``synth_case`` key files (tests/conftest.py)
through createCluster -> createSubSpace -> attachPickTimes -> SVD with
FAS on two null chunks a station, at dtype "double", matplotlib on Agg.

Tolerances: simMatrix's matrix within 1e-6 (the two packages' float32
correlations); as many figures as detex_tpu's, with the same titles;
each plotted line's x and y data within 1e-5 of the line's largest
absolute value (the beta fits of the two float32 nulls differ by ~1e-7
relative), scatter points and histogram bars equal within 1e-9; printed
lines identical.
"""
import os

import matplotlib
import numpy as np
import pytest

from detex_tpu import construct as jcon
from detex_tpu.data import fetcher as jget
import detex_torch
from detex_torch.data import fetcher as tget

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def built(synth_case, tmp_path_factory):
    """(ClusterStream, SubSpace) of each package after SVD with FAS."""
    wd = tmp_path_factory.mktemp("tplots")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(wd)
        mp.setenv("DETEX_TPU_MESH", "0")
        for p, con, get, kw in (("j", jcon, jget, {}),
                                ("t", detex_torch, tget,
                                 dict(device="cpu"))):
            cl = con.createCluster(
                CCreq=0.5, fetch_arg=synth_case["eventDir"],
                filt=[1, 8, 2, True], stationKey=synth_case["stationKey"],
                templateKey=synth_case["templateKey"], trim=[10, 60],
                saveclust=False, **kw)
            ss = con.createSubSpace(
                Pf=1e-9, clust=cl, conDatFetcher=get.DataFetcher(
                    "dir", directoryName=synth_case["conDir"]), **kw)
            ss.attachPickTimes(pksFile=synth_case["phaseKey"],
                               defaultDuration=20)
            ss.SVD(selectCriteria=2, selectValue=0.9, conDatNum=2,
                   useSingles=True)
            out[p] = (cl, ss)
    return out


@pytest.mark.parametrize("group", [False, True])
def test_sim_matrix_matches_jax(built, group):
    got = built["t"][0].simMatrix(groupClusts=group, returnMat=True)
    want = built["j"][0].simMatrix(groupClusts=group, returnMat=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.diag(g), 1.0)
    assert built["t"][0].simMatrix() == [None, None]


def _hold_axes(fa, fb):
    """Two figures' first axes: titles, lines, scatters and bars."""
    a, b = fa.axes[0], fb.axes[0]
    assert a.get_title() == b.get_title()
    la, lb = a.get_lines(), b.get_lines()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        for get in ("get_xdata", "get_ydata"):
            u = np.asarray(getattr(x, get)(), float)
            v = np.asarray(getattr(y, get)(), float)
            assert u.shape == v.shape
            scale = max(np.abs(v).max(), 1e-30)
            assert np.abs(u - v).max() <= 1e-5 * scale, (a.get_title(), get)
    for x, y in zip(a.collections, b.collections):
        np.testing.assert_allclose(x.get_offsets(), y.get_offsets(),
                                   rtol=0, atol=1e-9)
    ha = [p.get_height() for p in a.patches]
    hb = [p.get_height() for p in b.patches]
    np.testing.assert_allclose(ha, hb, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("method", ["plotThresholds", "plotFracEnergy",
                                    "plotAlignedEvents", "plotBasisVectors",
                                    "plotOffsetTimes"])
def test_subspace_plots_match_jax(built, method):
    got = getattr(built["t"][1], method)()
    want = getattr(built["j"][1], method)()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _hold_axes(g, w)


def test_cluster_plots_match_jax(built, tmp_path):
    (tcl, _), (jcl, _) = built["t"], built["j"]
    for t, j in zip(tcl.clusters, jcl.clusters):
        _hold_axes(t.plotEvents(), j.plotEvents())
        _hold_axes(t.plotEvents(plotSingles=False),
                   j.plotEvents(plotSingles=False))
        path = str(tmp_path / ("%s.png" % t.station))
        fig = t.dendro(show=False, saveName=path)
        assert os.path.getsize(path) > 0
        want = j.dendro(show=False)
        assert fig.axes[0].get_title() == want.axes[0].get_title()
        assert len(fig.axes[0].collections) == len(want.axes[0].collections)
    assert tcl.dendro(show=False) is None
    assert tcl.plotEvents() is None


def test_printers_match_jax(built, capsys):
    out = []
    for p in ("t", "j"):
        cl, ss = built[p]
        cl.printAtr()
        ss.printOffsets()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert out[0].count("\n") == 2 + 4
