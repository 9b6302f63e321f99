"""host_filter_share_pct: a wrap of detect.prepChunk, listed in the two
case1 cells only (never beside chunk_prep_share_pct, whose span has the
same name), reads a share of the tiny cell's traced window on the host
filter branch, and None on a program without detect.prepChunk."""
import json
import os
import time
import types

import pytest

from conftest import ROOT, tiny_cell

NAME = "host_filter_share_pct"


def listed():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {m["name"]: m for m in bench["per_layer"]}


def test_entry_and_cells():
    m = listed()[NAME]
    assert m["layer"] == listed()["host_prep_share_pct"]["layer"]
    assert m["source"] == "program_span"
    assert m["moves"] == "station_days_per_s"
    assert m["better"] == "lower" and m["unit"] == "%"
    cells = set(m["workloads"])
    assert cells == {"case1.archive", "case1.swarm"}
    assert not cells & set(listed()["chunk_prep_share_pct"]["workloads"])


@pytest.mark.parametrize("traffic", ["archive", "swarm"])
def test_tiny_traced_run_reads_a_share(traffic):
    from portbench.harness import bench
    res = tiny_cell(traffic)
    res["per_layer"] = [(listed()[NAME], bench.load_metric(NAME))]
    result, _, _ = bench.run_cell(res, 3000000019, 1.0, True, "cpu", 1,
                                  time.perf_counter())
    v = result["metrics"][NAME]["value"]
    assert 0 < v < 100, v


def test_missing_function_reads_none():
    """On a program without detect.prepChunk (the port before it) the wrap
    is skipped and the metric reads None, not 0."""
    from portbench.harness import bench
    from portbench.harness.trace import Spans
    mod = bench.load_metric(NAME)
    spans = Spans(True)
    for span, paths in mod.SPANS.items():
        for p in paths:
            spans.wrap(span, p + "_absent")
    assert not spans._undo
    assert mod.read(types.SimpleNamespace(spans=spans, window_s=1.0)) \
        is None
