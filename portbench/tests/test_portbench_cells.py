"""BENCHMARK.json against the contract's shape, and every cell resolved
to its configuration, traffic and metric files by name."""
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok)")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for c in b["configs"]:
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves_by_name(cell):
    from portbench.harness import bench as hb
    res = hb.resolve(ROOT, cell)
    assert res["config"]["name"] == res["workload"]["config"]
    assert res["traffic"]["name"] == res["workload"]["traffic"]
    names = {m["name"] for m, _ in res["end_to_end"]}
    assert {"setup_s", "station_days_per_s"} <= names
    assert res["per_layer"], "a cell reports at least one per-layer metric"
    for _, mod in res["end_to_end"] + res["per_layer"]:
        assert callable(mod.read)
    from portbench.harness import gen
    cell = gen.Cell(res["config"], res["traffic"])      # every key read
    for part in (cell.src, cell.win):
        assert part.__name__.rsplit(".", 1)[1] in (
            res["traffic"]["source"], res["traffic"]["window"])
    for key in [c for c in bench()["configs"]
                if c["name"] == res["workload"]["config"]][0]["reduced"]:
        assert key in res["config"]


def test_paths_hold_the_command():
    b = bench()
    assert b["paths"] == ["portbench"]
    assert b["command"][1].startswith("portbench/")
    assert os.path.exists(os.path.join(ROOT, b["command"][1]))
