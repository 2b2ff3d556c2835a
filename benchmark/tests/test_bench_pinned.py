"""The inputs of the one-chip cells are pinned: ``make_problem``'s words,
statistics, phenotypes, causal SNPs with their effects, and folds at the
tiny size for a fixed seed hash to what they hashed to before the harness
learnt to shard a cell (the digests were taken on that tree), so the
one-chip path makes the same inputs."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import data

SEED = 2**31 + 7
PINNED = {
    ("gauss10k.cv", 0): dict(
        words="58b07f8185a3defe8b6305e436b08f4b3fbb63d2b25c15ff358269667535b973",
        stats="bdca77740c54fab36e00201b80fcd6fbbb54db5f576e6fd0b2a6e81f0200be5e",
        ys="e2f51a9283c53af445a1a5cd5a937624269046da82f25b004037e96e8a7166b0",
        causal="15b53c3309e8dcff70f59166a15366fb289d68d59a2f7937946313e273a1650f",
        folds="1278a61ee0e77dda3d5943dc2dd0a5f7b540cb096a3d5196108af709390fd0b0"),
    ("gauss10k.fit", 0): dict(
        words="58b07f8185a3defe8b6305e436b08f4b3fbb63d2b25c15ff358269667535b973",
        stats="bdca77740c54fab36e00201b80fcd6fbbb54db5f576e6fd0b2a6e81f0200be5e",
        ys="47b9c7abcafd0084d80522174377077211f422215ef8d4ed810531ac333686a6",
        causal="e83852ce81c7f8117b8350ba2bcac688c09a6e0d47b244b6796e00f3f28a1f58",
        folds=None),
    ("gauss10k.fit", 0.25): dict(
        words="b069b6c2a0cbe28f6536102d83c0dd93340be3b968d214e955f18dd12fa16aac",
        stats="6353cde4d6e9d7c0ed708259e3193c21f5675ebed667a1527db159c22d54f660",
        ys="1f7c8106d1026de92cc8e95a0838a7dce2d22e8a1bfa9145ba59391d8d5306a8"),
}


def digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name, missing", list(PINNED),
                         ids=lambda x: str(x))
def test_one_chip_inputs_unchanged(tiny_cell, name, missing):
    _, _, config, traffic = tiny_cell(name)
    config = dict(config, genotypes=dict(config["genotypes"],
                                         missing_calls=missing))
    pr = data.make_problem(config, traffic, SEED, torch.device("cpu"))
    got = dict(words=digest(pr.words.numpy()),
               stats=digest(pr.mu, pr.inv_sd, pr.n_missing),
               ys=digest(*pr.ys), causal=digest(*pr.causal, *pr.betas),
               folds=digest(*pr.folds) if pr.folds else None)
    want = PINNED[name, missing]
    assert {k: got[k] for k in want} == want
