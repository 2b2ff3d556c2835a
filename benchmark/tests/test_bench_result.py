"""A run through the harness on the CPU at a tiny size: the result line's
keys are the contract's, with the numbers compared beside their limits
last."""

import json
import math
import time

import pytest
import torch

from benchmark import run


@pytest.mark.parametrize("name", ["gauss10k.fit", "gauss10k.cv"])
def test_result_keys(tiny_cell, name):
    bench, cell, config, traffic = tiny_cell(name)
    out = run.run_cell(bench, cell, config, traffic, 2**31 + 5, 0.5, False,
                       torch.device("cpu"), time.perf_counter(),
                       log=lambda s: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    want = {m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")}
    assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(traffic["limits"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "gauss10k.fit", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "mendeliht_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]


@pytest.mark.cuda
def test_traced_run_on_the_card(tiny_cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench, cell, config, traffic = tiny_cell("gauss10k.fit")
    out = run.run_cell(bench, cell, dict(config, n=10_000, p=65_536),
                       traffic, 9, 1.0, True, torch.device("cuda", 0),
                       time.perf_counter(), log=lambda s: None)
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert set(out["metrics"]) == {
        m["name"] for m in run.cell_metrics(bench, cell, "per_layer")}
    assert out["breakdown"]["device_ops"]
