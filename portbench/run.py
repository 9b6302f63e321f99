#!/usr/bin/env python3
"""
The benchmark of detex_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Reads BENCHMARK.json, makes the cell's
inputs from the seed, warms up, measures the window, checks the answers
against the float64 reference, and prints one JSON line last on standard
output (the numbers compared, each beside its limit, also last on standard
error). Exits non-zero, printing no result, without enough CUDA devices,
without detex_torch, or when jax, jaxlib, flax or detex_tpu were loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache a library could keep goes to a fixed place in the
    # checkout (the kernels build into detex_torch/kernels/_build)
    cache = os.path.join(ROOT, ".pbcache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    from portbench.harness import bench
    res = bench.resolve(ROOT, args.workload)
    chips = int(res["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: %s needs %d CUDA device(s); this host has %s"
              % (args.workload, chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else "none"), file=sys.stderr)
        return 2
    try:
        import detex_torch  # noqa: F401
    except ImportError as e:
        print("portbench: detex_torch is not importable: %s" % e,
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, nums, lines = bench.run_cell(res, args.seed, args.seconds,
                                         bool(args.trace), "cuda:0", chips,
                                         T_START)
    from detex_torch.ops import cuda_kernels
    from detex_torch.parallel import scan
    print("launches %s" % json.dumps(cuda_kernels.LAUNCHES))
    print("routes %s" % json.dumps(dict(scan.ROUTE_COUNTS)))
    card = _card_line()
    print("card %s" % card)
    result["device"]["power_limit"] = card.split(",")[-1].strip()
    bad = bench.banned_modules()
    if bad:
        print("portbench: the run loaded %s" % ", ".join(bad),
              file=sys.stderr)
        return 4
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
