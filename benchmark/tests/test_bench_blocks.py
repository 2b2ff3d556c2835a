"""The reference in rank blocks (``reference/blocks.py``) against the
whole reference, in float64: over 2 gloo ranks, each holding its own SNP
rows, ``ShardGenotypes.xtr`` / ``forward`` equal ``iht.Genotypes`` on the
whole words within a relative 1e-12, with and without the 0.25 missing
share, and a whole reference cv on them gives the single-process
reference's mse per k."""

import pickle
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT

from benchmark import data, world
from benchmark.reference import blocks, iht

import blocks_rank as br

DEADLINE = 240.0


def gap(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module", params=[0, 0.25], ids=["no_missing",
                                                       "missing"])
def case(request, tmp_path_factory):
    missing = request.param
    out = tmp_path_factory.mktemp("blocks")
    rc, _ = world.launch([sys.executable, str(ROOT / "benchmark" / "tests" /
                                              "blocks_rank.py"),
                          str(out), str(missing)], br.SHARDS, DEADLINE)
    assert rc == 0
    ranks = [pickle.load(open(out / f"blocks{float(missing)}_{r}.pkl", "rb"))
             for r in range(br.SHARDS)]
    words, _, _ = data.shard_words(br.N, br.P, 0, br.P, br.SEED, "cpu",
                                   missing)
    return missing, ranks, iht.Genotypes(words, br.N, br.P, torch.float64)


def test_xtr_and_forward_equal_the_whole(case):
    missing, ranks, G = case
    R, _, _ = br.inputs()
    idx, coef = br.forward_case()
    want_xtr = G.xtr(torch.as_tensor(R)).numpy()
    want_fwd = G.forward(idx, coef).numpy()
    assert G.has_missing == bool(missing)
    for out in ranks:
        assert out["has_missing"] == G.has_missing
        assert out["xtr"].shape == want_xtr.shape
        assert gap(out["xtr"], want_xtr) <= 1e-12
        assert gap(out["forward"], want_fwd) <= 1e-12


def test_reference_cv_equals_the_whole(case):
    missing, ranks, G = case
    _, y, folds = br.inputs()
    want = iht.cv(G, y, folds, br.PATH, br.Q, max_iter=30)
    for out in ranks:
        assert gap(out["mse"], want) <= 1e-12


def test_blocks_follow_the_gauss_modules():
    from benchmark.reference import gauss_cv, gauss_fit
    assert blocks.prepare_blocks(gauss_cv) is blocks.ShardGenotypes
    assert blocks.prepare_blocks(gauss_fit) is blocks.ShardGenotypes
