"""On the card: one short run of a cell through the command the driver
runs, correct, with its result line. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_short_archive_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "case1.archive", "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["station_days_per_s"]["value"] > 0
