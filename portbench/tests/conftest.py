"""Shared pieces of the benchmark's CPU tests: the tiny stand-in
configuration (tests/data/tiny.json) under each traffic mix, made small
enough for the CPU, and a run of it through the harness."""
import copy
import json
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# what each traffic mix becomes at the tiny size
TINY_TRAFFIC = {
    "archive": {"events_per_station_hour": 3},
    "swarm": {"events_per_station_hour": 20, "max_passes": 4},
    "feed": {"max_passes": 40, "events_per_station_hour": 3,
             "check": {"handed_chunks": 4, "event_chunks": 4,
                       "random_chunks": 4, "random_detectors": 3,
                       "hist_block_rows": 2}},
}


def tiny_cell(traffic, **cfg_over):
    """The harness's resolved cell for the tiny configuration under
    ``traffic`` (a feed gets the device filter, as network-1000 has)."""
    from portbench.harness import bench
    with open(os.path.join(HERE, "data", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           traffic + ".json")) as f:
        tr = json.load(f)
    tr.update(copy.deepcopy(TINY_TRAFFIC[traffic]))
    if traffic == "feed":
        # the device filter without a band-pass: at this size the program's
        # response, sampled 2/N off the rfft bins, moves the histograms
        # past their limit (at the cells' sizes it does not; PERF.md)
        cfg["device_prep"] = True
        cfg["filt"] = None
    cfg.update(cfg_over)
    e2e = [(dict(name=n, unit="u"), bench.load_metric(n))
           for n in ("station_days_per_s", "setup_s")]
    return dict(workload=dict(name="tiny." + traffic, chips=1), config=cfg,
                traffic=tr, end_to_end=e2e, per_layer=[])


def run_tiny(traffic, seed=20260417, seconds=1.0, also_control=False, **kw):
    from portbench.harness import bench
    return bench.run_cell(tiny_cell(traffic, **kw), seed, seconds, False,
                          "cpu", 1, time.perf_counter(),
                          also_control=also_control)


@pytest.fixture
def tiny():
    return run_tiny
