"""BENCHMARK.json resolves, by name, to the files of the harness, and keeps
the contract's shape."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    conf = configs[cell["config"]]
    assert (ROOT / conf["file"]).is_file()
    assert json.loads((ROOT / conf["file"]).read_text())["name"] == conf["name"]
    assert (ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").is_file()
    assert cell["chips"] == 1
    assert len(cell["why"]) <= 200
    for m in BENCH["per_layer"]:
        if cell["name"] in m.get("workloads", []):
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    units = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(units.match(m["unit"]) for m in metrics)
    assert {m["better"] for m in metrics} <= {"lower", "higher"}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_reports_enough():
    from benchmark import run
    for cell in BENCH["workloads"]:
        e2e = run.cell_metrics(BENCH, cell, "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert run.cell_metrics(BENCH, cell, "per_layer")


def test_every_config_is_used():
    used = {c["config"] for c in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
