"""The inputs a seed makes: the same again for the same seed, in the port's
layout, with the reference's statistics."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import decode

CPU = torch.device("cpu")


def test_phenotypes_and_folds_repeat(tiny_cell):
    _, _, config, traffic = tiny_cell("gauss10k.cv")
    seed = 2**33 + 11                    # past 32 signed bits
    a = data.make_problem(config, traffic, seed, CPU)
    b = data.make_problem(config, traffic, seed, CPU)
    assert torch.equal(a.words, b.words)
    assert len(a.ys) == len(a.folds) == traffic["inputs"]
    for x, y in zip(a.ys + a.folds + a.causal, b.ys + b.folds + b.causal):
        assert np.array_equal(x, y)
    c = data.make_problem(config, traffic, seed + 1, CPU)
    assert not torch.equal(a.words, c.words)
    assert not np.array_equal(a.ys[0], c.ys[0])


def test_same_effect_sizes_every_seed(tiny_cell):
    _, _, config, traffic = tiny_cell("gauss10k.fit")
    sizes = sorted(data.effect_sizes(10))
    for seed in (1, 2):
        pr = data.make_problem(config, traffic, seed, CPU)
        for beta in pr.betas:
            assert np.allclose(sorted(np.abs(beta)), sizes)
    assert sizes[0] == pytest.approx(0.0627, abs=1e-4)


@pytest.mark.parametrize("n, p", [(512, 4096), (1001, 58)])
def test_words_codes_and_stats(n, p):
    gen = torch.Generator().manual_seed(5)
    words, sums, miss = data.make_words(n, p, gen, CPU)
    n4 = data.padded_n4(n)
    assert words.shape == (-(-p // 4), n4) and n4 % 512 == 0
    c = decode.codes(decode.quad_rows_bytes(words), 4 * n4)
    assert not bool((c == 1).any())                  # no missing call
    assert not miss.any()
    assert not bool(c[:, n:].any())                  # padding samples 00
    assert not bool(c[p:].any())                     # padding SNPs 00
    v, _ = decode.values(c[:p, :n], torch.float64)
    assert np.array_equal(v.sum(dim=1).numpy(), sums)
    share = [(c[:p, :n] == k).double().mean().item() for k in (0, 2, 3)]
    assert share == pytest.approx([0.5, 0.25, 0.25], abs=0.02)
    mu, inv_sd = data.standardization(sums, n)
    assert np.allclose(mu, sums / n)
    assert np.allclose(inv_sd, 1 / np.sqrt(mu * (1 - mu / 2)))


@pytest.mark.parametrize("n, p", [(512, 4096), (1001, 58)])
def test_missing_share_quarter(n, p):
    gen = torch.Generator().manual_seed(6)
    words, sums, miss = data.make_words(n, p, gen, CPU, missing=0.25)
    n4 = data.padded_n4(n)
    c = decode.codes(decode.quad_rows_bytes(words), 4 * n4)
    assert not bool(c[:, n:].any()) and not bool(c[p:].any())
    assert np.array_equal((c[:p, :n] == 1).sum(dim=1).numpy(), miss)
    v, _ = decode.values(c[:p, :n], torch.float64)
    assert np.array_equal(v.sum(dim=1).numpy(), sums)
    share = [(c[:p, :n] == k).double().mean().item() for k in range(4)]
    assert share == pytest.approx([0.25] * 4, abs=0.02)
    mu, _ = data.standardization(sums, n, miss)
    assert np.allclose(mu, sums / (n - miss))


@pytest.mark.parametrize("share", [0.1, 0.5])
def test_other_missing_shares_refused(share):
    with pytest.raises(ValueError, match="missing_calls"):
        data.make_words(512, 64, torch.Generator(), CPU, missing=share)


def test_family_without_a_model_refused(tiny_cell):
    _, _, config, traffic = tiny_cell("gauss10k.fit")
    with pytest.raises(ValueError, match="phenotype model"):
        data.make_problem(dict(config, family="Bernoulli",
                               link="LogitLink"), traffic, 1, CPU)
    with pytest.raises(ValueError, match="links"):
        data.make_problem(dict(config, link="LogLink"), traffic, 1, CPU)


def test_phenotype_is_x_beta(tiny_cell):
    _, _, config, traffic = tiny_cell("gauss10k.fit")
    pr = data.make_problem(config, traffic, 3, CPU)
    import mendeliht_tpu_torch as mt
    g = mt.PackedGenotypes(words=pr.words,
                           mu=torch.as_tensor(pr.mu, dtype=torch.float64),
                           inv_sd=torch.as_tensor(pr.inv_sd,
                                                  dtype=torch.float64),
                           n=pr.n, p=pr.p, has_missing=False)
    x = g.to_dense_standardized()
    noise = pr.ys[0] - x[:, pr.causal[0]] @ pr.betas[0] - 1.0
    assert abs(noise.mean()) < 0.2 and 0.8 < noise.std() < 1.2
