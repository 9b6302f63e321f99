"""Without a card, or without the program, a run exits non-zero and
prints no result; nothing the benchmark loads is jax, jaxlib, flax or
detex_tpu, compared by whole top-level name."""
import os
import shutil
import subprocess
import sys

from conftest import ROOT

GUARD = """
import sys, glob, importlib.util, os
sys.path.insert(0, %r)
from portbench.harness import bench, check, drive, gen, trace, counts
from portbench.reference import engine64
for p in glob.glob(os.path.join(%r, "portbench", "metrics", "*.py")):
    bench.load_metric(os.path.basename(p)[:-3])
for kind in ("sources", "windows"):
    for p in glob.glob(os.path.join(%r, "portbench", "harness", kind,
                                    "*.py")):
        gen.load_part(kind, os.path.basename(p)[:-3]) \
            if not p.endswith("__init__.py") else None
import json
for p in glob.glob(os.path.join(%r, "portbench", "traffic", "*.json")):
    json.load(open(p))
bad = sorted({m.split(".")[0] for m in sys.modules} &
             {"jax", "jaxlib", "flax", "detex_tpu"})
assert not bad, bad
assert "detex_torch" not in sys.modules, "the harness imported the program"
print("clean")
"""


def run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_imports_are_clean():
    out = run(["-c", GUARD % (ROOT, ROOT, ROOT, ROOT)], ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_banned_names_compared_whole():
    from portbench.harness import bench
    sys.modules["detex_tpu_like"] = sys
    try:
        assert "detex_tpu" not in bench.banned_modules()
    finally:
        del sys.modules["detex_tpu_like"]


def no_result(out):
    return not any(ln.startswith("{") for ln in out.stdout.splitlines())


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(["portbench/run.py", "--workload", "case1.archive", "--seed",
               "3000000000", "--seconds", "1", "--trace", "0"], ROOT, env)
    assert out.returncode != 0 and no_result(out), out.stderr[-2000:]


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(["portbench/run.py", "--workload", "net1000.feed", "--seed",
               "1", "--seconds", "1", "--trace", "0"], str(tmp_path))
    assert out.returncode != 0 and no_result(out), out.stderr[-2000:]
