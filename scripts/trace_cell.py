#!/usr/bin/env python3
"""
One run of a portbench cell with detex_torch's own spans and counters on
over the measured window (detex_torch.trace; the harness's spans and the
profiler stay off), for where the engine's host time goes by span, by
thread, and what the counters saw.

    python3 scripts/trace_cell.py --workload case1.swarm --seed 7 \
        [--seconds 50] [--root .]

``--root`` is the checkout whose detex_torch and portbench are run (a
parent unpacked beside this one, say). Prints the cell's end-to-end
numbers, then one JSON line: per span its calls, total and self seconds
and its seconds by thread ("engine" for the window's thread, "other" for
the rest), the counters' change over the window, and the prep's
milliseconds a chunk. Needs a CUDA device unless ``--device cpu``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from collections import defaultdict  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--root", default=".")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("trace_cell: no CUDA device", file=sys.stderr)
        return 2
    from detex_torch import trace
    from portbench.harness import bench
    from portbench.harness.drive import Run
    res = bench.resolve(root, args.workload)
    real_window = Run.window
    seen = {}

    def window(self):
        trace.reset()
        seen["before"] = trace.counters()
        seen["engine"] = threading.get_ident()
        trace.enable()
        try:
            real_window(self)
        finally:
            trace.disable()
            seen["after"] = trace.counters()
            seen["spans"] = trace.snapshot()["spans"]

    Run.window = window
    result, _, lines = bench.run_cell(res, args.seed, args.seconds, False,
                                      args.device,
                                      int(res["workload"]["chips"]), T_START)
    for line in lines[:1]:
        print(line)
    spans = seen["spans"]
    by_thread = defaultdict(lambda: defaultdict(float))
    for s in spans:
        who = "engine" if s["thread"] == seen["engine"] else "other"
        by_thread[s["name"]][who] += (s["end_ns"] - s["start_ns"]) / 1e9
    report = [dict(r, threads=dict(by_thread[r["name"]]))
              for r in trace.report(spans)]
    keys = set(seen["after"]) | set(seen["before"])
    counts = {k: seen["after"].get(k, 0) - seen["before"].get(k, 0)
              for k in sorted(keys) if not k.startswith(("launches.",
                                                         "routes."))}
    prep = next((r for r in report if r["name"] == "prep"), None)
    print(json.dumps(dict(
        workload=args.workload, seed=args.seed, root=root,
        correct=result["correct"],
        metrics={k: v["value"] for k, v in result["metrics"].items()},
        prep_ms_per_chunk=(1e3 * prep["total_s"] / prep["calls"]
                           if prep else None),
        spans=report, counters=counts)))
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
