"""The plain reference against the port on the CPU (the port's CPU path,
unquantised f32) at 512 x 4,096: the same support and best k, close
numbers, also with missing calls; and the reference's own pieces against
dense numpy."""

import numpy as np
import pytest
import torch

from benchmark import data, run
from benchmark.reference import gauss_cv, gauss_fit, iht

CPU = torch.device("cpu")


@pytest.fixture
def problem(tiny_cell):
    def make(name, seed=7, missing=0):
        _, _, config, traffic = tiny_cell(name)
        config = dict(config, genotypes=dict(config["genotypes"],
                                             missing_calls=missing))
        pr = data.make_problem(config, traffic, seed, CPU)
        return pr, run.Calls(traffic, config,
                             run.make_genotypes(pr, config, traffic), pr)
    return make


@pytest.mark.parametrize("missing", [0, 0.25])
def test_xtr_and_columns_against_dense(problem, missing):
    pr, _ = problem("gauss10k.fit", missing=missing)
    assert pr.has_missing == bool(missing)
    G = iht.Genotypes(pr.words, pr.n, pr.p, torch.float64)
    assert np.allclose(G.mu.numpy(), pr.mu) and np.allclose(
        G.inv_sd.numpy(), pr.inv_sd)
    import mendeliht_tpu_torch as mt
    g = mt.PackedGenotypes(words=pr.words, mu=torch.as_tensor(pr.mu),
                           inv_sd=torch.as_tensor(pr.inv_sd), n=pr.n,
                           p=pr.p, has_missing=pr.has_missing,
                           n_missing=pr.n_missing)
    x = g.to_dense_standardized()
    R = np.random.default_rng(0).standard_normal((3, pr.n))
    got = G.xtr(torch.as_tensor(R)).numpy()
    assert np.allclose(got, R @ x, rtol=1e-10, atol=1e-9)
    idx = torch.tensor([[0, 5, 4095], [17, 17, 3]])
    cols = G.columns(idx).numpy()
    assert np.allclose(cols[1, 0], x[:, 17]) and np.allclose(cols[0, 2],
                                                             x[:, 4095])


@pytest.mark.parametrize("missing", [0, 0.25])
def test_fit_matches_port(problem, missing):
    pr, calls = problem("gauss10k.fit", missing=missing)
    G = iht.Genotypes(pr.words, pr.n, pr.p, torch.float64)
    for j in range(3):
        got = calls(j)
        ref = gauss_fit.run(G, pr.ys[j], None, dict(k=10, max_iter=200))
        assert np.array_equal(got["support"], ref["support"])
        assert got["iter"] == ref["iter"]
        nums = gauss_fit.compare(got, ref)
        assert nums["coef_gap"] < 1e-3 and nums["logl_gap"] < 1e-6
        assert len(set(ref["support"]) & set(pr.causal[j])) >= 8


@pytest.mark.parametrize("missing", [0, 0.25])
def test_cv_matches_port(problem, missing):
    pr, calls = problem("gauss10k.cv", missing=missing)
    G = iht.Genotypes(pr.words, pr.n, pr.p, torch.float64)
    got = calls(0)
    ref = gauss_cv.run(G, pr.ys[0], pr.folds[0],
                       dict(path=list(range(1, 21)), q=5, max_iter=100))
    nums = gauss_cv.compare(got, ref)
    assert np.argmin(got["mse"]) == np.argmin(ref["mse"])
    assert nums["mse_gap"] < 1e-3
    assert np.argmin(ref["mse"]) + 1 in range(8, 15)


def test_compare_counts_a_missed_snp():
    a = dict(support=np.array([1, 5]), beta=np.array([2.0, 0.5]), c=1.0,
             logl=-10.0)
    b = dict(support=np.array([1, 7]), beta=np.array([2.0, 0.5]), c=1.0,
             logl=-10.0)
    assert gauss_fit.compare(a, b)["coef_gap"] == 0.25
    assert gauss_cv.compare(dict(mse=[3.0, 1.0]),
                            dict(mse=[1.0, 2.0])) == dict(mse_gap=2.0)
