"""A rank of the test of the reference's rank blocks: this rank's SNP rows
of the seed's matrix as ``reference/blocks.py::ShardGenotypes``, and what
the test compares with the whole matrix's ``iht.Genotypes``.

    python blocks_rank.py OUT_DIR MISSING --rank r

joins a gloo world through the environment (``world.launch``), and writes
``OUT_DIR/blocks{MISSING}_{r}.pkl``: X' R for R of ``R_ROWS`` rows,
X[:, idx] coef for the idx and coef of ``forward_case`` and the mse per k
of a reference cv.
"""

import datetime
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import data  # noqa: E402
from benchmark.reference import blocks, iht  # noqa: E402

N, P, SEED, SHARDS = 512, 4096, 2**31 + 21, 2
R_ROWS = 3
PATH, Q = list(range(1, 11)), 3


def forward_case():
    """(idx, coef) (3, 6): SNPs of both shards, the first and last, and a
    repeat."""
    idx = torch.tensor([[0, 5, 2047, 2048, 4095, 17],
                        [17, 17, 3, 3000, 2500, 1],
                        [4000, 10, 2049, 2046, 0, 4094]])
    coef = torch.as_tensor(np.random.default_rng(3).standard_normal(
        idx.shape))
    return idx, coef


def inputs():
    """R (R_ROWS, N), y (N,) and folds (N,) of the test."""
    rng = np.random.default_rng(11)
    return (rng.standard_normal((R_ROWS, N)), rng.standard_normal(N),
            rng.integers(1, Q + 1, size=N))


def main(out_dir: str, missing: float, rank: int):
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=60))
    per = P // SHARDS
    words, _, _ = data.shard_words(N, P, rank * per, per, SEED, "cpu",
                                   missing)
    G = blocks.ShardGenotypes(words, N, P, rank * per, None, torch.float64)
    R, y, folds = inputs()
    idx, coef = forward_case()
    out = dict(xtr=G.xtr(torch.as_tensor(R)).numpy(),
               forward=G.forward(idx, coef).numpy(),
               has_missing=G.has_missing,
               mse=iht.cv(G, y, folds, PATH, Q, max_iter=30))
    with open(Path(out_dir) / f"blocks{missing}_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv[0], float(argv[1]), int(argv[argv.index("--rank") + 1]))
