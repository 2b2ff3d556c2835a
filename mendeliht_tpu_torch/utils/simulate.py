"""Simulated packed genotypes at benchmark scale, generated on the host.

At 10k x 1M the dense code matrix would take 10 GB, so genotypes are drawn
directly as packed bytes, chunk by chunk, and written straight into the
quad-word storage.  For the same ``rng`` the bytes, stats and causal
effects are those of the JAX package's benchmark generator
(``bench.py::_gen_problem``).
"""

from __future__ import annotations

import numpy as np

from ..genotype.snparray import _LANE, _ceil_to, _stats_from_counts

_CHUNK = 8192          # SNP rows per generated chunk (a multiple of 4)


def _byte_luts():
    """Per-byte-value lookup tables over its four crumbs: the byte with
    every missing crumb (code 01) recoded to 00, and the crumb counts of
    codes 10 (het), 11 (alt) and 01 (missing)."""
    b = np.arange(256, dtype=np.uint16)
    crumbs = [(b >> (2 * s)) & 3 for s in range(4)]
    no_miss = b.copy()
    for s, c in enumerate(crumbs):
        no_miss[c == 1] &= ~np.uint16(3 << (2 * s))
    het = sum((c == 2).astype(np.uint8) for c in crumbs)
    alt = sum((c == 3).astype(np.uint8) for c in crumbs)
    mis = sum((c == 1).astype(np.uint8) for c in crumbs)
    return no_miss.astype(np.uint8), het, alt, mis


def simulate_packed_problem(rng: np.random.Generator, n: int, p: int,
                            k: int = 10, missing: bool = False):
    """Uniform random genotype codes as quad words, with per-SNP stats and
    ``k`` causal SNPs.

    Without ``missing``, code 01 is recoded to 00 so no genotype is missing
    (like the reference's benchmark simulations); with it, about a quarter
    of the genotypes are missing.  Samples past n are code 0.

    Returns (words (ceil(p/4), n4) int32, mu (p,), inv_sd (p,) float64,
    has_missing, causal (k,) SNP indices, beta (k,) effects)."""
    n4 = _ceil_to(-(-n // 4), _LANE)
    p4 = -(-p // 4)
    words = np.zeros((p4, n4), np.dtype("<i4"))
    quads = words.view(np.uint8).reshape(p4, n4, 4)
    n_het = np.zeros(p, np.int64)
    n_alt = np.zeros(p, np.int64)
    n_mis = np.zeros(p, np.int64)
    no_miss, het, alt, mis = _byte_luts()
    # crumb s of byte b is sample s*n4 + b: bytes past n - s*n4 get it cleared
    pad_masks = [(max(0, min(n4, n - s * n4)), np.uint8(0xFF ^ (3 << (2 * s))))
                 for s in range(4)]
    for lo in range(0, p, _CHUNK):
        hi = min(lo + _CHUNK, p)
        blk = rng.integers(0, 256, size=(hi - lo, n4), dtype=np.uint8)
        if not missing:
            blk = no_miss[blk]
        for first_pad, mask in pad_masks:
            if first_pad < n4:
                blk[:, first_pad:] &= mask
        n_het[lo:hi] = het[blk].sum(axis=1, dtype=np.int64)
        n_alt[lo:hi] = alt[blk].sum(axis=1, dtype=np.int64)
        n_mis[lo:hi] = mis[blk].sum(axis=1, dtype=np.int64)
        c4 = -(-(hi - lo) // 4)
        if 4 * c4 != hi - lo:
            blk = np.concatenate(
                [blk, np.zeros((4 * c4 - (hi - lo), n4), np.uint8)])
        quads[lo // 4:lo // 4 + c4] = blk.reshape(c4, 4, n4).transpose(0, 2, 1)
    mu, inv_sd, _ = _stats_from_counts(n - n_mis, n_het, n_alt)
    causal = rng.choice(p, size=k, replace=False)
    beta = rng.standard_normal(k)
    return words.view(np.int32), mu, inv_sd, bool(n_mis.sum() > 0), causal, beta
