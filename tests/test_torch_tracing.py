"""The port's named spans (``utils/profiling.py::span``) in ``fit_iht`` and
``cv_iht``, on the CPU: under ``torch.profiler`` they nest as the layers
do, their counts are the solver's iterations, backtracks and host syncs,
and the answers are the same bit for bit; with no profiler recording no
``record_function`` is entered."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mendeliht_tpu_torch as mt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, d=None):
    """300 x 600 genotypes on the CPU and a response with 5 causal SNPs;
    seed 4 gives a Gaussian fit that backtracks."""
    rng = np.random.default_rng(seed)
    x, _ = mt.simulate_random_snparray(None, 300, 600, rng=rng, device="cpu")
    y, _, _ = mt.simulate_random_response(x, 5, d or mt.Normal(), rng=rng)
    return x, y


def _fit(x, y, verbose=False, **kw):
    return mt.fit_iht(y, x, k=5, verbose=verbose, **kw)


def _cv(x, y):
    return mt.cv_iht(y, x, path=range(1, 6), q=3, verbose=False,
                     folds=np.arange(x.n) % 3 + 1)


CALLS = {"fit": (_fit, "iht.fit"), "cv": (_cv, "iht.cv")}


def _traced(call):
    """(call's result, the host ``iht.*`` events of a CPU profile of it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    return out, [e for e in prof.events() if e.name.startswith("iht.")]


def _parent(e):
    """The name of the innermost ``iht.*`` span that encloses ``e``."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("iht."):
        p = p.cpu_parent
    return None if p is None else p.name


def _within(spans, outer):
    """The names of the spans whose innermost ``iht.*`` parent is
    ``outer``."""
    return {e.name for e in spans if _parent(e) == outer}


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_spans_nest_as_the_layers(kind):
    call, top = CALLS[kind]
    x, y = _problem(1)
    _, spans = _traced(lambda: call(x, y))
    assert [e.name for e in spans if _parent(e) is None] == [top]
    want = {"iht.build", "iht.init", "iht.solve", "iht.finalize",
            "iht.fetch"} | ({"iht.masks"} if kind == "cv" else set())
    assert _within(spans, top) == want
    assert _within(spans, "iht.solve") == {"iht.iteration", "iht.sync"}
    assert _within(spans, "iht.iteration") >= {
        "iht.stepsize", "iht.project", "iht.forward", "iht.score",
        "iht.sync"}
    assert _within(spans, "iht.stepsize") == {"iht.forward"}
    assert _within(spans, "iht.init") == {"iht.score"}
    assert "iht.project" in _within(spans, "iht.finalize")


@pytest.mark.parametrize("seed,d", [(4, mt.Normal()), (2, mt.Bernoulli())],
                         ids=["normal", "bernoulli"])
def test_span_counts_are_iterations_backtracks_and_syncs(seed, d):
    x, y = _problem(seed, d)
    lines = io.StringIO()
    with contextlib.redirect_stdout(lines):
        res, spans = _traced(lambda: _fit(x, y, d=d, verbose=True))
    assert res.iter < 200                                # converged
    # task 0's line of each iteration gives its backtracking rounds
    rounds = sum(map(int, re.findall(r"backtracks = (\d+)",
                                     lines.getvalue())))
    assert rounds > 0
    count = {name: sum(e.name == name for e in spans)
             for name in ("iht.iteration", "iht.backtrack", "iht.sync")}
    assert count["iht.iteration"] == res.iter
    assert count["iht.backtrack"] == rounds
    # run_segment's active.any() before each iteration and once after the
    # last, and _iteration's need.any() after each step
    assert count["iht.sync"] == 2 * res.iter + 1 + rounds


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_no_record_function_without_a_profiler(kind, monkeypatch):
    call, _ = CALLS[kind]
    x, y = _problem(1)
    rf = torch.autograd.profiler.record_function
    enter, entered = rf.__enter__, []

    def counting(self):
        entered.append(self.name)
        return enter(self)
    monkeypatch.setattr(rf, "__enter__", counting)
    call(x, y)
    assert entered == []
    _traced(lambda: call(x, y))
    assert entered and all(n.startswith("iht.") for n in entered)


@pytest.mark.parametrize("kind", sorted(CALLS))
def test_answers_are_the_same_with_the_profiler(kind):
    call, _ = CALLS[kind]
    x, y = _problem(1)
    off = call(x, y)
    on, spans = _traced(lambda: call(x, y))
    assert spans
    if kind == "cv":
        np.testing.assert_array_equal(on, off)
        return
    for field in ("beta", "c"):
        np.testing.assert_array_equal(getattr(on, field), getattr(off, field))
    assert (on.logl, on.iter, on.sigma_g) == (off.logl, off.iter, off.sigma_g)
