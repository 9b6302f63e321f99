"""
A cell's run from BENCHMARK.json: find its configuration, traffic and
metric files by name, set up, run the window (traced or not), read the
metrics, check the answers, and build the result line.

A configuration is BENCHMARK.json's ``file``; a traffic mix is
portbench/traffic/<traffic>.json; a metric, end to end or per layer, is
portbench/metrics/<name>.py with ``read(t)`` (a number, or None where it
finds nothing to read) and optionally SPANS = {span: ["module:attr",
...]}, the program functions whose calls it times in the traced run.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

from portbench.harness import check as _check
from portbench.harness import counts as _counts
from portbench.harness.drive import Run, profiled

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "detex_tpu")


def banned_modules():
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (detex_torch is not detex_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(BANNED))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(root, workload):
    """The cell ``workload`` of root/BENCHMARK.json with its files read:
    dict(workload, config, traffic, metrics: [(spec, module)])."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    w = [x for x in bench["workloads"] if x["name"] == workload]
    if not w:
        raise KeyError("no workload %r in BENCHMARK.json" % workload)
    w = w[0]
    cfg_spec = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    cfg = load_json(os.path.join(root, cfg_spec["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in reported]
    return dict(workload=w, config=cfg, traffic=traffic,
                end_to_end=[(m, load_metric(m["name"])) for m in e2e],
                per_layer=[(m, load_metric(m["name"])) for m in layer])


def load_metric(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" +
                                                  name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class View(object):
    """What a metric reads."""

    def __init__(self, run, setup_s, dtrace):
        self.run = run
        self.cell = run.cell
        self.cfg = run.cfg
        self.setup_s = setup_s
        self.window_s = run.window_s
        self.chunks_scanned = run.chunks_scanned
        self.station_days = run.chunks_scanned * run.cell.chunk_s / 86400.0
        self.spans = run.spans
        self.device = dtrace
        self.counts = _counts


def run_cell(res, seed, seconds, trace, device, n_cards, t_start,
             workdir=None, also_control=False):
    """One run; returns (result dict, numbers compared, stderr lines).
    ``also_control`` reads, after the program's numbers, the control's on
    the same window's chunks into result["control"]."""
    import torch
    own = workdir is None
    if own:
        workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        metrics = res["per_layer"] if trace else res["end_to_end"]
        run = Run(res["config"], res["traffic"], seed, seconds, device,
                  workdir, n_cards=n_cards)
        run.setup()
        run.warmup()
        run.spans.on = bool(trace)
        if trace:
            for _, mod in metrics:
                for span, paths in getattr(mod, "SPANS", {}).items():
                    for p in paths:
                        run.spans.wrap(span, p)
        gc.collect()
        setup_s = time.perf_counter() - t_start
        try:
            with profiled(trace) as prof:
                run.window()
        finally:
            run.spans.unwrap()
        dtrace = None
        if trace:
            from portbench.harness.trace import DeviceTrace
            dtrace = DeviceTrace(prof, n_cards, run.window_s)
            del prof
        view = View(run, setup_s, dtrace)
        out = {}
        for spec, mod in metrics:
            v = mod.read(view)
            if v is not None:
                out[spec["name"]] = {"value": float(v), "unit": spec["unit"]}
        dev = dict(platform="gpu" if str(device).startswith("cuda")
                   else "cpu", count=n_cards)
        if dev["platform"] == "gpu":
            dev["kind"] = torch.cuda.get_device_name(0)
            dev["memory_peak_bytes"] = max(
                torch.cuda.max_memory_allocated(i) for i in range(n_cards))
            torch.cuda.empty_cache()
        if trace:
            dev["busy_s"] = sum(dtrace.busy_s) / len(dtrace.busy_s)
            dev["window_s"] = run.window_s
        prog = _check.program_answers(run)
        t_ref = time.perf_counter()
        nums = _check.compare(run, prog)
        ref_s = time.perf_counter() - t_ref
        ctl = _check.compare(run, None, control=True) if also_control \
            else None
        per_chunk = max(run.cell.pad_c - run.cell.n_c + 1, 1)
        result = {
            "correct": all(nums.v[k] <= lim
                           for k, lim in _check.LIMITS.items()),
            "attempted": run.chunks_scanned,
            "failed": int(-(-nums.v["hist_count_miss"] //
                            max(per_chunk, 1)) if nums.v["hist_count_miss"]
                          else 0),
            "metrics": out,
            "device": dev,
        }
        if trace:
            result["breakdown"] = dict(device_ops=dtrace.device_ops,
                                       idle_gaps=dtrace.idle_gaps)
        if ctl is not None:
            result["control"] = dict(ctl.v)
        result["checks"] = {k: {"value": nums.v[k], "limit": lim}
                            for k, lim in _check.LIMITS.items()}
        lines = ["window %.6f s, %d chunks (%d passes), reference %.3f s"
                 % (run.window_s, run.chunks_scanned, run.passes, ref_s)]
        lines += ["note: %s" % n for n in nums.notes]
        lines += ["check %s %r limit %r" % (k, nums.v[k], lim)
                  for k, lim in _check.LIMITS.items()]
        return result, nums, lines
    finally:
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
