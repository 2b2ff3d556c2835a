"""A sharded cell's configuration and inputs: the ``mesh`` key and what the
harness refuses before any data is made; each rank's SNP rows of the
seed's matrix, the same whole matrix at any number of shards."""

import numpy as np
import pytest
import torch

from benchmark import data, run
from benchmark.reference import decode, gauss_fit
from mendeliht_tpu_torch.parallel import multihost

CPU = torch.device("cpu")
MESH = {"task": 1, "snp": 2}


@pytest.mark.parametrize("chips, mesh, match", [
    (2, None, "no mesh"),
    (4, MESH, "is not 4 chips"),
    (2, {"task": 2, "snp": 2}, "is not 2 chips"),
])
def test_refused_before_any_data(tiny_cell, monkeypatch, capsys, chips,
                                 mesh, match):
    bench, cell, config, traffic = tiny_cell("gauss10k.cv")
    config = dict(config, mesh=mesh) if mesh else config
    cell = dict(cell, chips=chips)
    monkeypatch.setattr(run, "load_cell",
                        lambda name: (bench, cell, config, traffic))
    for name in ("make_problem", "make_shard_problem", "make_words"):
        monkeypatch.setattr(data, name, pytest.fail)
    rc = run.main(["--workload", "gauss10k.cv", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    got = capsys.readouterr()
    assert rc != 0 and got.out == ""
    assert match in got.err


def test_reference_without_rank_blocks_refused(tiny_cell, monkeypatch):
    _, cell, config, traffic = tiny_cell("gauss10k.fit")
    monkeypatch.setattr(gauss_fit, "prepare", lambda *args: None)
    with pytest.raises(ValueError, match="cannot run in rank blocks"):
        run.sharding(dict(cell, chips=2), dict(config, mesh=MESH), traffic)


def test_mesh_is_read(tiny_cell):
    _, cell, config, traffic = tiny_cell("gauss10k.fit")
    assert run.sharding(cell, config, traffic) is None
    assert run.sharding(dict(cell, chips=2), dict(config, mesh=MESH),
                        traffic) == MESH
    assert run.sharding(cell, dict(config, mesh={"task": 1, "snp": 1}),
                        traffic) == {"task": 1, "snp": 1}


@pytest.mark.parametrize("n, p, shards", [(512, 4096, 2), (1001, 58, 3),
                                          (600, 403, 4)])
@pytest.mark.parametrize("missing", [0, 0.25])
def test_shards_make_one_matrix(monkeypatch, n, p, shards, missing):
    """Rank rows of multihost.shard_rows, in blocks of 7 quad rows so that
    shards start inside blocks: the shards stacked are the matrix of one
    shard, pad rows are zero words, and each shard's counts are its rows'
    of the whole."""
    monkeypatch.setattr(data, "BLOCK_ROWS", 7)
    seed = 2**31 + 3
    p_pad, _ = multihost.shard_rows(p, shards)
    per = p_pad // shards
    whole, sums, miss = data.shard_words(n, p, 0, p_pad, seed, CPU, missing)
    parts = [data.shard_words(n, p, s * per, per, seed, CPU, missing)
             for s in range(shards)]
    assert torch.equal(torch.cat([w for w, _, _ in parts]), whole)
    assert np.array_equal(np.concatenate([s for _, s, _ in parts]), sums)
    assert np.array_equal(np.concatenate([m for _, _, m in parts]), miss)
    n4 = data.padded_n4(n)
    c = decode.codes(decode.quad_rows_bytes(whole), 4 * n4)
    assert not bool(c[p:].any()) and not bool(c[:, n:].any())
    assert bool((c[:p, :n] == 1).any()) == bool(missing)
    v, _ = decode.values(c[:p, :n], torch.float64)
    assert np.array_equal(v.sum(dim=1).numpy(), sums[:p])
    assert np.array_equal((c[:p, :n] == 1).sum(dim=1).numpy(), miss[:p])
    _, inv_sd = data.standardization(sums, n, miss)
    assert not inv_sd[p:].any()
    other, _, _ = data.shard_words(n, p, 0, p_pad, seed + 1, CPU, missing)
    assert not torch.equal(other, whole)


def test_shard_problem_of_one_rank(tiny_cell):
    """With no other rank, a shard is the whole matrix: phenotypes X beta +
    intercept + noise of its own causal SNPs, and folds for a cv."""
    _, _, config, traffic = tiny_cell("gauss10k.cv")
    pr = data.make_shard_problem(config, traffic, 5, CPU, 0, config["p"])
    assert pr.words.shape == (config["p"] // 4, data.padded_n4(config["n"]))
    assert len(pr.ys) == len(pr.folds) == traffic["inputs"]
    assert not pr.has_missing
    for j in (0, 7):
        eta = decode.x_beta(pr.words, pr.causal[j], pr.betas[j], pr.n, pr.mu,
                            pr.inv_sd) + 1.0
        noise = pr.ys[j] - eta
        assert abs(noise.mean()) < 0.2 and 0.8 < noise.std() < 1.2
        assert set(pr.folds[j]) == set(range(1, 6))
    again = data.make_shard_problem(config, traffic, 5, CPU, 0, config["p"])
    assert np.array_equal(np.stack(again.ys), np.stack(pr.ys))
