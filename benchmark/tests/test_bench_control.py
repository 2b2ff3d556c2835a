"""What ``correct`` has to catch, at a tiny size on the CPU: the control
(the reference in bfloat16 in the program's place) reads above a limit,
and so does a run with each fault that these cells can have planted in
the program underneath the harness.  The fault across chips has no place
in these one-chip cells."""

import dataclasses
import time

import pytest
import torch

from benchmark import control, run

CPU = torch.device("cpu")
CELLS = ["gauss10k.fit", "gauss10k.cv"]


def over(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(tiny_cell, name):
    _, _, config, traffic = tiny_cell(name)
    for seed in (101, 102, 103):
        got = control.readings(config, traffic, seed, 1, CPU)
        assert over(got["control"], traffic["limits"]), got
        assert not over(got["program"], traffic["limits"]), got


def unchanged_step(monkeypatch, n):
    from mendeliht_tpu_torch.models import univariate
    monkeypatch.setattr(univariate, "_iteration", lambda op, data, cfg, st:
                        dataclasses.replace(st, iteration=st.iteration + 1))


def half_the_samples(monkeypatch, n):
    from mendeliht_tpu_torch.ops import glm
    score_residual = glm.score_residual

    def half(*args, **kwargs):
        r = score_residual(*args, **kwargs).clone()
        r[..., n // 2:] = 0.0
        return r
    monkeypatch.setattr(glm, "score_residual", half)


def altered_answer(monkeypatch, n):
    from mendeliht_tpu_torch.models import cv, fit
    extract, fused = fit._sparse_extract, cv.cv_fused

    def extract_1pct(op, st, sigma_g):
        out = list(extract(op, st, sigma_g))
        out[2] = out[2] * 1.01                    # the selected effects
        return tuple(out)
    monkeypatch.setattr(fit, "_sparse_extract", extract_1pct)
    monkeypatch.setattr(cv, "cv_fused", lambda *a, **k: fused(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", [unchanged_step, half_the_samples,
                                   altered_answer], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    bench, cell, config, traffic = tiny_cell(name)
    fault(monkeypatch, config["n"])
    out = run.run_cell(bench, cell, config, traffic, 2**32 + 3, 0.2, False,
                       CPU, time.perf_counter(), log=lambda s: None)
    assert out["correct"] is False, out["checks"]
