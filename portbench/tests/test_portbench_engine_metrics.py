"""The engine's per-layer metrics (chunk_prep_share_pct, batch_share_pct,
upload_share_pct, wait_share_pct): each wraps one program function by
name, reads a number in the tiny cell's traced run, and reads None on a
program that lacks the function."""
import json
import os
import time
import types

import pytest

from conftest import ROOT, tiny_cell

NEW = ("chunk_prep_share_pct", "batch_share_pct", "upload_share_pct",
       "wait_share_pct")
CELL = {"archive": "case1.archive", "feed": "net1000.feed",
        "swarm": "case1.swarm"}


def per_layer(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])]


def test_entries_and_files():
    from portbench.harness import bench
    got = {m["name"]: m for m in per_layer("net1000.feed")}
    for name in NEW:
        m = got[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "station_days_per_s"
        assert m["better"] == "lower" and m["unit"] == "%"
        mod = bench.load_metric(name)
        assert callable(mod.read) and mod.SPANS
    for cell in ("case1.archive", "case1.swarm"):
        names = {m["name"] for m in per_layer(cell)}
        assert names >= set(NEW) - {"chunk_prep_share_pct"}
        assert "chunk_prep_share_pct" not in names   # host_prep reads it


@pytest.mark.parametrize("traffic", sorted(CELL))
def test_tiny_traced_run_reads_each_metric(traffic):
    from portbench.harness import bench
    res = tiny_cell(traffic)
    specs = per_layer(CELL[traffic])
    res["per_layer"] = [(m, bench.load_metric(m["name"])) for m in specs]
    result, _, _ = bench.run_cell(res, 3000000017, 1.0, True, "cpu", 1,
                                  time.perf_counter())
    got = result["metrics"]
    for m in specs:
        if m["name"] in NEW:
            v = got[m["name"]]["value"]
            assert 0 < v < 100, (m["name"], v)
    names = {k for k, _ in result["breakdown"]["idle_gaps"]}
    assert names <= {"fetch", "host_prep", "reverify", "rows", "engine",
                     "chunk_prep", "batch", "upload", "wait"}


@pytest.mark.parametrize("name", NEW)
def test_missing_function_reads_none(name):
    """On a program without the wrapped function (the port before these
    functions existed) the wrap is skipped and the metric reads None."""
    from portbench.harness import bench
    from portbench.harness.trace import Spans
    mod = bench.load_metric(name)
    spans = Spans(True)
    for span, paths in mod.SPANS.items():
        for p in paths:
            spans.wrap(span, p + "_absent")
    assert not spans._undo
    assert mod.read(types.SimpleNamespace(spans=spans, window_s=1.0)) \
        is None
