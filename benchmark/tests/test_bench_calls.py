"""The call a cell makes comes from its files: the traffic's entry and
arguments, unchanged, with the configuration's family, link and
precision; what the reference module does not follow is refused before a
run; the longest call is always among those checked."""

import time

import numpy as np
import pytest
import torch

from benchmark import data, run

CPU = torch.device("cpu")


def test_arguments_reach_the_entry_unchanged(tiny_cell, monkeypatch):
    import mendeliht_tpu_torch as mt
    _, _, config, traffic = tiny_cell("gauss10k.cv")
    traffic = dict(traffic, inputs=2)
    pr = data.make_problem(config, traffic, 4, CPU)
    seen = []
    monkeypatch.setattr(mt, "cv_iht", lambda y, g, **kw: seen.append(
        (y, g, kw)) or np.ones(20))
    calls = run.Calls(traffic, config, run.make_genotypes(pr, config,
                                                          traffic), pr)
    assert calls(3)["input"] == 1
    y, g, kw = seen[0]
    assert y is pr.ys[1] and kw.pop("folds") is pr.folds[1]
    assert kw.pop("d") == mt.Normal() and kw.pop("l") == mt.IdentityLink()
    assert kw == dict(traffic["args"], dtype="float32")
    assert g.mu.dtype == torch.float32


def test_precision_from_the_configuration(tiny_cell):
    _, _, config, traffic = tiny_cell("gauss10k.fit")
    config = dict(config, dtype="float64")
    traffic = dict(traffic, inputs=1)
    pr = data.make_problem(config, traffic, 4, CPU)
    g = run.make_genotypes(pr, config, traffic)
    assert g.mu.dtype == torch.float64
    assert run.call_args(config, traffic)["dtype"] == "float64"
    assert run.call_args(config, dict(traffic, args=dict(
        traffic["args"], dtype="float32")))["dtype"] == "float32"


@pytest.mark.parametrize("change, match", [
    (dict(args={"k": 10, "init_beta": True}), "init_beta"),
    (dict(reference="gauss_cv", args={"path": [1], "debias": True}),
     "debias"),
], ids=["init_beta", "debias"])
def test_arguments_the_reference_lacks_are_refused(tiny_cell, change,
                                                   match):
    bench, cell, config, traffic = tiny_cell("gauss10k.fit")
    with pytest.raises(ValueError, match=match):
        run.run_cell(bench, cell, config, dict(traffic, **change), 1, 0.1,
                     False, CPU, time.perf_counter(), log=lambda s: None)


def test_family_the_reference_lacks_is_refused(tiny_cell):
    bench, cell, config, traffic = tiny_cell("gauss10k.cv")
    config = dict(config, family="Bernoulli", link="LogitLink")
    with pytest.raises(ValueError, match="Bernoulli"):
        run.run_cell(bench, cell, config, traffic, 1, 0.1, False, CPU,
                     time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("kind", ["fit", "cv"])
def test_longest_call_is_checked(kind):
    answers = [dict(input=i % 4) for i in range(12)]
    walls = [1.0] * 12
    walls[6] = 9.0
    picks = run.checked_calls(answers, walls, dict(kind=kind,
                                                   check_calls=2), 5)
    assert picks[0] == 6 and len(picks) == 2
    assert answers[picks[1]]["input"] != answers[6]["input"]
