#!/usr/bin/env python3
"""
Record detex_tpu's synthetic Case1 pipeline as a JSON fixture.

    python scripts/record_case1_reference.py [--out PATH]

Runs tests/test_pipeline.py's calls (SynthCatalog -> write_directories ->
createCluster -> createSubSpace with a 'dir' DataFetcher ->
attachPickTimes -> SVD with FAS -> detex -> detResults) at the parameters
of the ``synth_case`` fixture (tests/conftest.py), once at dtype "double"
and once at "single", on the CPU, and writes what detex_torch is held
against where detex_tpu is not run (chip_smoke.py and the port import
nothing of JAX or detex_tpu):
clusters and singles, each station's lag matrix, each subspace's
alignment delays, each detector's NumBasis and threshold, the ss_df /
sg_df rows (Sta, Name, STMP, DS, Mag), detResults' Dets / Autos / Vers
(Event, MSTAMPmin, MSTAMPmax, DSav, NumStations) and the planted hidden
events. The file also holds the parameters, so its readers run the same
pipeline from it, and the environment detex_tpu ran in (ENV: no device
mesh, and the Pallas and matmul-DFT switches on, which also snap detex_tpu's
overlap-save block to 16384 as detex_torch's rule does), which this
script sets for its run.

Default output: tests/data/case1_reference.json. Re-run it when
detex_tpu's pipeline, its synthetic catalog or these parameters change;
tests/test_torch_pipeline.py regenerates the record and holds it equal to
the committed file. Imports detex_tpu only (numpy, scipy and the standard
library besides); reads nothing back with pandas.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "case1_reference.json")

ENV = {"DETEX_TPU_MESH": "0", "DETEX_TPU_PALLAS": "1",
       "DETEX_TPU_MATMUL_FFT": "1"}
# tests/conftest.py synth_case and tests/test_pipeline.py's calls
PARAMS = {
    "synth": dict(n_sources=2, events_per_source=3, n_singles=1,
                  n_stations=2, sr=25.0, span_hours=20, seed=1, noise=0.04),
    "hidden": dict(n=2, mag=1.4, sources=[0, 1]),
    "directories": dict(tb4=10, taft=60),
    "createCluster": dict(CCreq=0.5, filt=[1, 8, 2, True], trim=[10, 60]),
    "createSubSpace": dict(Pf=1e-9, minEvents=2),
    "attachPickTimes": dict(defaultDuration=20),
    "SVD": dict(selectCriteria=2, selectValue=0.9, conDatNum=4,
                useSingles=True, backupThreshold=0.25),
    "detex": dict(useSingles=True, estimateMags=True),
    "detResults": dict(requiredNumStations=2, veriBuffer=4),
}
DTYPES = ("double", "single")
RESULT_COLUMNS = ["Event", "MSTAMPmin", "MSTAMPmax", "DSav", "NumStations"]
ROW_COLUMNS = ["Sta", "Name", "STMP", "DS", "Mag"]


@contextlib.contextmanager
def environment(env):
    """os.environ with ``env`` set, restored on exit."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(dtype, workdir):
    """detex_tpu's Case1 pipeline at ``dtype`` under ``workdir``. Returns
    (record, objects): the record as described in the module docstring,
    and {"paths", "cat", "clust", "ss", "db", "res"}."""
    from scipy.cluster.hierarchy import linkage

    from detex_tpu import align, construct, results, util
    from detex_tpu.data import fetcher as getdata
    from detex_tpu.data.synth import SynthCatalog

    p = PARAMS
    cat = SynthCatalog(**p["synth"])
    cat.add_hidden_events(**p["hidden"])
    paths = cat.write_directories(os.path.join(workdir, "data"),
                                  **p["directories"])
    clust = construct.createCluster(
        fetch_arg=paths["eventDir"], stationKey=paths["stationKey"],
        templateKey=paths["templateKey"], saveclust=False, dtype=dtype,
        fileName=os.path.join(workdir, "clust.pkl"), **p["createCluster"])
    cfetcher = getdata.DataFetcher("dir", directoryName=paths["conDir"])
    ss = construct.createSubSpace(clust=clust, dtype=dtype,
                                  conDatFetcher=cfetcher,
                                  **p["createSubSpace"])
    rec = {"clusters": {}, "lags": {}, "delays": {}, "detectors": {},
           "rows": {}, "results": {}}
    for cl in clust.clusters:
        rec["clusters"][cl.station] = dict(
            events=list(cl.key), clusts=[sorted(c) for c in cl.clusts],
            singles=list(cl.singles))
        row = clust.trdf[clust.trdf.Station == cl.station].iloc[0]
        m = len(row.Events)
        lag = construct._square_from_df(row.Lags, m, fill=0.0)
        rec["lags"][cl.station] = [[int(x) for x in r] for r in lag]
    for sta, df in ss.subspaces.items():
        rec["delays"][sta] = {}
        for _, srow in df.iterrows():
            cc, lag = construct._getInfoFromClust(clust, srow)
            link = linkage(construct._flatNoNan(construct.DISSIM_OFFSET -
                                                cc))
            d = align.alignment_delays(link, cc, lag)
            rec["delays"][sta][srow.Name] = dict(
                zip(srow.Events, [int(x) for x in d]))
    ss.attachPickTimes(pksFile=paths["phaseKey"], **p["attachPickTimes"])
    ss.SVD(**p["SVD"])
    for sta in sorted(set(ss.subspaces) | set(ss.singles)):
        dets = []
        for kind, frames in (("ss", ss.subspaces), ("sg", ss.singles)):
            if sta not in frames:
                continue
            for _, r in frames[sta].iterrows():
                dets.append(dict(kind=kind, Name=r.Name,
                                 Events=list(r.Events),
                                 NumBasis=int(r.NumBasis) if kind == "ss"
                                 else None, Threshold=float(r.Threshold)))
        rec["detectors"][sta] = dets
    db = os.path.join(workdir, "SubSpace.db")
    ss.detex(subspaceDB=db, **p["detex"])
    for table in ("ss_df", "sg_df"):
        df = util.loadSQLite(db, table)
        rec["rows"][table] = [
            [str(r.Sta), str(r.Name), float(r.STMP), float(r.DS),
             float(r.Mag)] for _, r in df.iterrows()]
    res = results.detResults(
        ssDB=db, templateKey=paths["templateKey"],
        stationKey=paths["stationKey"], veriFile=paths["veriFile"],
        fetch=cfetcher, **p["detResults"])
    for name in ("Dets", "Autos", "Vers"):
        df = getattr(res, name)
        rec["results"][name] = [
            [str(r.Event), float(r.MSTAMPmin), float(r.MSTAMPmax),
             float(r.DSav), int(r.NumStations)] for _, r in df.iterrows()]
    rec["hidden"] = [dict(src=int(e["src"]), time=float(e["time"]),
                          mag=float(e["mag"])) for e in cat.hidden]
    return rec, dict(paths=paths, cat=cat, clust=clust, ss=ss, db=db,
                     res=res)


def record(workdir, dtypes=DTYPES):
    """The whole fixture: {"env", "params", "columns", <dtype>: record},
    each dtype run in its own directory under ``workdir`` with ENV set.
    Returns (fixture, {dtype: objects})."""
    out = {"env": dict(ENV), "params": PARAMS,
           "columns": {"rows": ROW_COLUMNS, "results": RESULT_COLUMNS}}
    objs = {}
    with environment(ENV):
        for dtype in dtypes:
            wd = os.path.join(workdir, dtype)
            os.makedirs(wd, exist_ok=True)
            out[dtype], objs[dtype] = run(dtype, wd)
    return out, objs


def dumps(fixture):
    return json.dumps(fixture, indent=1, sort_keys=True) + "\n"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as wd:
        cwd = os.getcwd()
        os.chdir(wd)
        try:
            fixture, _ = record(wd)
        finally:
            os.chdir(cwd)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(dumps(fixture))
    print("wrote %s" % args.out)


if __name__ == "__main__":
    main()
