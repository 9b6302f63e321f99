#!/usr/bin/env python3
"""
The readings the limits of ``correct`` are set from, on the card at a
cell's own size: for each seed, one run of the program (set-up, warm-up,
a window of --seconds, the comparison with the float64 reference) and,
on the same chunks, the control in the program's place (the reference
with its stage boundaries in bfloat16). One JSON line a seed:

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--program-only <n> ...]

Seeds under --program-only read the program alone. Not a run of the
benchmark: the benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-only", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    from portbench.harness import bench
    import torch
    res = bench.resolve(ROOT, args.workload)
    chips = int(res["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("needs %d CUDA device(s)" % chips, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    todo = [(s, True) for s in args.seeds] + \
        [(s, False) for s in args.program_only]
    for seed, with_control in todo:
        t0 = time.perf_counter()
        result, nums, lines = bench.run_cell(
            res, seed, args.seconds, False, "cuda:0", chips, t0,
            also_control=with_control)
        print(json.dumps(dict(
            workload=args.workload, seed=seed, correct=result["correct"],
            program=dict(nums.v), control=result.get("control"),
            metrics={k: v["value"] for k, v in result["metrics"].items()},
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
