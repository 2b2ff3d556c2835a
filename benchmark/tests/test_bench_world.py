"""A sharded cell through the launcher on the CPU: 2 gloo ranks of a tiny
cell (512 x 4,096 over a 1 x 2 mesh), started by ``run.launch_cell`` as
the benchmark's command starts them on cards.

- The cv and the fit each print one line, ``correct`` true, with the
  numbers compared last on standard error; their answers equal those of
  one process on the same whole words within the float32 reduction-order
  bounds of the port's multi-process tests (fits: the same support, beta
  and c within 1e-3, logl within 1e-2, ``tests/test_torch_multihost.py``;
  cvs: mse within rtol 1e-4 and the same best k,
  ``tests/test_torch_parallel.py``), and every rank holds the same
  phenotypes, folds and answers.  A traced run logs each rank's reading.
- A rank whose call raises, or that exits in the window, ends the run
  non-zero within its deadline, with no rank left running; a call that
  fails on every rank, or that returns a non-finite answer on one, counts
  as failed on all and the run goes on.
- Each rank refuses a result where a module of JAX is loaded in it: a
  world that ends 0 had none in any rank.
"""

import argparse
import contextlib
import io
import json
import os
import pickle
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY

from benchmark import data, run

PROGRAM = str(ROOT / "benchmark" / "tests" / "bench_rank.py")
SEED = 2**31 + 11
ALLOWANCE = 120.0              # s, a world's deadline past --seconds
FAULT_ALLOWANCE = 40.0
COLLECTIVE_TIMEOUT = 10.0
CPU = torch.device("cpu")
CELLS = [("gauss10k.cv", 2.0, 0), ("gauss10k.fit", 1.0, 1)]


def world(tmp, name, seconds, trace=0, **spec):
    """Launch a 2-rank world of the tiny ``name``, dumping into ``tmp``.
    Returns (exit code, seconds, standard output, standard error, the
    spec's path)."""
    spec = dict(cell=name, chips=2, config=dict(
        TINY, mesh={"task": 1, "snp": 2}), dump=str(tmp), **spec)
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    args = argparse.Namespace(workload=name, seed=SEED, seconds=seconds,
                              trace=trace)
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.launch_cell(
            args, 2, "cpu", program=[sys.executable, PROGRAM, str(path)],
            t_start=t0,
            allowance=FAULT_ALLOWANCE if spec.get("fault") else ALLOWANCE,
            collective_timeout=COLLECTIVE_TIMEOUT)
    return rc, time.perf_counter() - t0, out.getvalue(), err.getvalue(), path


def left_running(spec_path) -> list:
    """Processes whose command line names ``spec_path``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            continue
        if str(spec_path).encode() in cmd:
            found.append(int(pid))
    return found


def dumped(tmp, what, rank):
    with open(tmp / f"{what}{rank}.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{cell: (dump directory, what ``world`` returns)}: the cv untraced,
    the fit traced."""
    out = {}
    for name, seconds, trace in CELLS:
        tmp = tmp_path_factory.mktemp(name)
        out[name] = tmp, world(tmp, name, seconds, trace)
    return out


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_one_correct_line(runs, name):
    _, (rc, _, out, err, path) = runs[name]
    assert rc == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["count"] == 2
    traced = dict((c[0], c[2]) for c in CELLS)[name]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device"] + ["breakdown"] * traced + ["checks"]
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert tail == [f"check {k} {c['value']!r} limit {c['limit']!r}"
                    for k, c in res["checks"].items()]
    assert not left_running(path)


@pytest.mark.parametrize("name", [c[0] for c in CELLS])
def test_answers_equal_one_process(runs, tiny_cell, name):
    tmp, _ = runs[name]
    _, _, config, traffic = tiny_cell(name)
    whole = data.make_shard_problem(config, traffic, SEED, CPU, 0,
                                    config["p"])
    inputs = [dumped(tmp, "inputs", r) for r in (0, 1)]
    answers = [dumped(tmp, "answers", r) for r in (0, 1)]
    assert [(x["lo"], x["per"]) for x in inputs] == [(0, 2048), (2048, 2048)]
    want = np.stack(whole.ys)                  # X beta summed over ranks
    for x in inputs:
        assert (np.max(np.abs(np.stack(x["ys"]) - want))
                <= 1e-12 * np.max(np.abs(want)))
        for f, g in zip(x["folds"], whole.folds):
            np.testing.assert_array_equal(f, g)
    assert len(answers[0]) >= 1
    for a, b in zip(*answers):                    # the ranks agree
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    calls = run.Calls(traffic, config,
                      run.make_genotypes(whole, config, traffic), whole)
    for i, got in enumerate(answers[0]):
        want = calls(i)
        if traffic["kind"] == "cv":
            np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-4)
            assert np.argmin(got["mse"]) == np.argmin(want["mse"])
            continue
        np.testing.assert_array_equal(got["support"], want["support"])
        np.testing.assert_allclose(got["beta"], want["beta"], atol=1e-3)
        assert got["c"] == pytest.approx(want["c"], abs=1e-3)
        assert got["logl"] == pytest.approx(want["logl"], abs=1e-2)


def test_traced_run_reads_every_rank(runs):
    _, (rc, _, out, err, _) = runs["gauss10k.fit"]
    res = json.loads(out)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert res["breakdown"]["idle_gaps"]
    trace = [s for s in err.splitlines() if s.startswith("[rank 0] trace: ")]
    summary = json.loads(trace[0][len("[rank 0] trace: "):])
    assert len(summary["ranks"]) == 2
    for r in summary["ranks"]:
        assert set(r) == {"busy_s", "wall_s", "nccl_ms"}
        assert r["wall_s"] > 0
    assert summary["ranks"][0]["wall_s"] == res["device"]["window_s"]
    assert summary["calls"] == 8 and res["attempted"] == 8


@pytest.mark.parametrize("fault", ["raise", "exit", "jax"])
def test_a_failing_rank_ends_the_world(tmp_path, fault):
    seconds = 3.0
    rc, took, out, err, path = world(tmp_path, "gauss10k.fit", seconds,
                                     fault=fault, fault_rank=1)
    assert rc != 0 and out == ""
    assert took < seconds + FAULT_ALLOWANCE + 30
    assert not left_running(path)
    if fault == "jax":
        assert "modules of JAX or the JAX package loaded: ['jax']" in err


@pytest.mark.parametrize("fault, rank", [("raise", "all"), ("nan", 1)])
def test_a_failed_call_counts_on_every_rank(tmp_path, fault, rank):
    rc, _, out, err, _ = world(tmp_path, "gauss10k.fit", 3.0, fault=fault,
                               fault_rank=rank)
    assert rc == 0, err[-4000:]
    res = json.loads(out)
    assert res["failed"] == 1 and res["correct"] is False
    assert res["attempted"] >= 2
    answers = [dumped(tmp_path, "answers", r) for r in (0, 1)]
    assert answers[0][1] is None and answers[1][1] is None
