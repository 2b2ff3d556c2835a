"""Simulation utilities (reference src/simulate_utilities.jl), generated on
the host from a numpy ``rng``.

The JAX package's simulators draw the same numbers in the same order here
(``utils/simulate.py`` there) and return genotypes on the device asked for
(default the card), optionally also written as a PLINK ``.bed``.  At
benchmark scale, 10k x 1M, the dense code matrix would take 10 GB, so
:func:`simulate_packed_problem` draws packed bytes, chunk by chunk, straight
into the quad-word storage: for the same ``rng`` the bytes, stats and causal
effects of the JAX package's benchmark generator (``bench.py::_gen_problem``).
GLM responses over packed genotypes decode only the causal SNPs
(:func:`simulate_random_response`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..genotype.plink import write_plink_bed
from ..genotype.snparray import (PackedGenotypes, _LANE, _ceil_to,
                                 _stats_from_counts, codes_to_values,
                                 unpack_codes)
from ..ops import glm
from .device import resolve_device

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


def _standardized_columns(x, idx) -> np.ndarray:
    """(n, len(idx)) float64 standardized, mean-imputed columns ``idx`` of
    x: for packed genotypes, decoded from the quad words of those SNPs
    alone (as ``to_dense_standardized`` decodes every column); else the
    columns of the dense matrix x (numpy, or a tensor on any device), used
    verbatim."""
    if isinstance(x, torch.Tensor):
        on = torch.as_tensor(idx, device=x.device)
        return x[:, on].cpu().double().numpy()
    if not isinstance(x, PackedGenotypes):
        return np.asarray(x, np.float64)[:, idx]
    on = torch.as_tensor(idx, device=x.device)
    rows = x.words[on // 4].cpu().numpy()
    quads = rows.astype(np.dtype("<i4"), copy=False).view(np.uint8)
    quads = quads.reshape(len(idx), rows.shape[1], 4)
    packed = quads[np.arange(len(idx)), :, idx % 4]           # (k, n4)
    vals = codes_to_values(unpack_codes(packed, x.n))         # NaN = missing
    mu = x.mu[on].cpu().double().numpy()
    inv = x.inv_sd[on].cpu().double().numpy()
    vals = np.where(np.isnan(vals), mu[:, None], vals)
    return ((vals - mu[:, None]) * np.where(inv == 0, 1.0, inv)[:, None]).T


def _linkinv_f32(link: str, eta: np.ndarray) -> np.ndarray:
    """g^{-1}(eta) as the JAX simulator evaluates it: the identity returns
    eta as it is; any other link runs in float32 (its jnp arithmetic without
    64-bit mode)."""
    if link == "identity":
        return eta
    return glm.linkinv(link, torch.from_numpy(eta).float()).numpy()


def simulate_random_response(x, k: int, d=None, l=None, r=10, alpha=1,
                             Zu=None, rng=None):
    """Simulate a univariate GLM response with k causal SNPs (reference
    src/simulate_utilities.jl:207-242; the JAX package's
    ``utils/simulate.py::simulate_random_response`` draw for draw).  Returns
    (y, true_b, correct_position).

    ``x`` is a PackedGenotypes (on any device; only the k causal columns
    are decoded, on the host, so 10k x 1M costs what 10 columns do) or a
    dense (n, p) matrix (numpy, or a tensor on any device).  Families: normal, bernoulli, poisson,
    negativebinomial (``r``), gamma (``alpha``; log link), inversegaussian;
    ``Zu`` (n,) is added to the linear predictor."""
    rng = np.random.default_rng() if rng is None else rng
    d = d if d is not None else glm.Normal()
    dist = glm.dist_name(d)
    link = glm.link_name(l) if l is not None else glm._CANONICAL[dist]
    n, p = x.shape
    if dist in ("negativebinomial", "gamma") and link != "log":
        raise ValueError(f"Distribution {dist} must use LogLink!")
    Zu = np.zeros(n) if Zu is None else np.asarray(Zu).reshape(n)

    true_b = np.zeros(p)
    scale = 0.3 if dist in ("poisson", "gamma", "negativebinomial") else 1.0
    true_b[:k] = rng.normal(0, scale, size=k)
    rng.shuffle(true_b)
    correct_position = np.flatnonzero(true_b)

    eta = (_standardized_columns(x, correct_position)
           @ true_b[correct_position] + Zu)
    if dist in ("normal", "poisson", "bernoulli"):
        if dist == "normal":
            y = rng.normal(np.clip(_linkinv_f32(link, eta), -1e20, 1e20), 1.0)
        else:
            mu = _linkinv_f32(link, np.clip(eta, -20, 20))
            if dist == "poisson":
                y = rng.poisson(np.clip(mu, 0, 1e8)).astype(np.float64)
            else:
                y = rng.binomial(1, np.clip(mu, 0, 1)).astype(np.float64)
    elif dist == "negativebinomial":
        mu = np.exp(np.clip(eta, -20, 20))
        prob = 1.0 / (1.0 + mu / r)
        y = rng.negative_binomial(r, prob).astype(np.float64)
    elif dist == "gamma":
        mu = np.exp(eta)
        beta_rate = 1.0 / mu
        y = rng.gamma(alpha, 1.0 / beta_rate)
    elif dist == "inversegaussian":
        # Wald sampling with unit shape, mean = linkinv(eta)
        mu = _linkinv_f32(link, np.clip(eta, -20, 20))
        y = rng.wald(np.clip(mu, 1e-3, 1e6), 1.0)
    else:
        raise ValueError(f"cannot simulate distribution {dist}")
    return y.astype(np.float64), true_b, correct_position


def random_covariance_matrix(n: int, kappa: float = 10.0, rng=None):
    """Random SPD matrix with condition number <= kappa (reference
    src/simulate_utilities.jl:319-326; the JAX package's draws)."""
    rng = np.random.default_rng() if rng is None else rng
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sigma = rng.uniform(1, np.sqrt(kappa), size=n)
    A = Q @ np.diag(sigma) @ Q.T
    return A.T @ A


def simulate_random_multivariate_response(x, k: int, traits: int, Zu=None,
                                          overlap: int = 0, Sigma=None,
                                          rng=None):
    """Multi-trait Gaussian phenotypes with k causal SNPs in all and
    ``overlap`` causal SNPs shared by every trait (reference
    src/simulate_utilities.jl:266-308; the JAX package's
    ``utils/simulate.py::simulate_random_multivariate_response`` draw for
    draw, but that with ``overlap=0`` the drawn effects are kept).
    ``Sigma`` fixes the trait covariance instead of drawing one.
    ``x`` as in :func:`simulate_random_response`: only the causal columns
    are decoded.

    Returns (Y (n, traits), Sigma, true_b (p, traits), correct_position)."""
    rng = np.random.default_rng() if rng is None else rng
    n, p = x.shape
    if traits * overlap > k:
        raise ValueError("traits * overlap cannot exceed k!")
    Zu = np.zeros((n, traits)) if Zu is None else np.asarray(Zu)

    true_b = np.zeros((p, traits))
    if overlap == 0:
        # k entries of the column-major (p, traits) matrix, as the
        # reference's linear indexing places them.  The JAX package draws
        # the same numbers but writes them into the copy that ravel(order=
        # "F") returns, so its true_b stays zero (ROADMAP Queue 3)
        causal = rng.choice(traits * p, size=k, replace=False)
        tb = true_b.ravel(order="F")
        tb[causal] = rng.standard_normal(k)
        true_b = tb.reshape(p, traits, order="F")
    else:
        shared = rng.choice(p, size=overlap, replace=False)
        for t in range(traits):
            true_b[shared, t] = rng.standard_normal(overlap)
        flat_ok = np.ones(traits * p, bool)
        for t in range(traits):
            flat_ok[t * p + shared] = False
        rest = rng.choice(np.flatnonzero(flat_ok), size=k - traits * overlap,
                          replace=False)
        tb = true_b.ravel(order="F")
        tb[rest] = rng.standard_normal(k - traits * overlap)
        true_b = tb.reshape(p, traits, order="F")
    correct_position = np.argwhere(true_b != 0)

    if Sigma is None:
        Sigma = random_covariance_matrix(traits, rng=rng)
    else:
        Sigma = np.asarray(Sigma, np.float64)
    cols = np.flatnonzero((true_b != 0).any(axis=1))
    mu = _standardized_columns(x, cols) @ true_b[cols] + Zu
    L = np.linalg.cholesky(Sigma)
    Y = mu + rng.standard_normal((n, traits)) @ L.T
    return Y, Sigma, true_b, correct_position


def _values_to_codes(vals: np.ndarray) -> np.ndarray:
    """{0,1,2} additive values -> PLINK codes {0,2,3} (no missing)."""
    codes = np.zeros(vals.shape, np.uint8)
    codes[vals == 1] = 2
    codes[vals == 2] = 3
    return codes


def _finish(s, codes: np.ndarray, device) -> PackedGenotypes:
    """(n, p) codes -> PackedGenotypes on ``device`` (default the card),
    written first to the ``.bed`` path ``s`` where it is a string."""
    device = resolve_device(device)
    if isinstance(s, str):
        write_plink_bed(s, codes)
    return PackedGenotypes.from_codes(codes, device=device)


def simulate_random_snparray(s, n: int, p: int, mafs=None, min_ma: int = 5,
                             rng=None, device=None):
    """Random genotypes: SNP j ~ Binomial(2, maf_j), maf ~ U(0, 0.5) unless
    given; re-draws until each SNP has > min_ma minor alleles (reference
    src/simulate_utilities.jl:23-80; the JAX package's draws).

    ``s``: output .bed path or None.  Returns (PackedGenotypes on
    ``device``, default the card; mafs)."""
    rng = np.random.default_rng() if rng is None else rng
    fixed_mafs = mafs is not None and np.any(np.asarray(mafs) != 0)
    if fixed_mafs:
        mafs = np.asarray(mafs, np.float64)
        if not np.all((0.0 <= mafs) & (mafs <= 0.5)):
            raise ValueError("Minor allele frequencies not in (0, 0.5)")
    out_mafs = np.zeros(p)
    vals = np.zeros((n, p), np.uint8)
    todo = np.arange(p)
    maf_cur = mafs.copy() if fixed_mafs else rng.uniform(0, 0.5, size=p)
    for _ in range(10000):
        if todo.size == 0:
            break
        draw = (rng.random((n, todo.size)) < maf_cur[todo]).astype(np.uint8) \
            + (rng.random((n, todo.size)) < maf_cur[todo]).astype(np.uint8)
        vals[:, todo] = draw
        ok = draw.sum(axis=0) > min_ma
        out_mafs[todo[ok]] = maf_cur[todo[ok]]
        todo = todo[~ok]
        if not fixed_mafs:
            maf_cur[todo] = rng.uniform(0, 0.5, size=todo.size)
    if todo.size:
        raise RuntimeError("could not satisfy min_ma for some SNPs")
    return _finish(s, _values_to_codes(vals), device), out_mafs


def simulate_correlated_snparray(s, n: int, p: int, block_length: int = 20,
                                 hap: int = 20, prob: float = 0.75, rng=None,
                                 device=None):
    """LD-block haplotype model (reference src/simulate_utilities.jl:119-186;
    the JAX package's draws): SNPs in blocks of `block_length`; within a
    block each sample draws 2 of `hap` haplotypes; adjacent haplotype
    alleles repeat w.p. `prob`.  Returns PackedGenotypes on ``device``
    (default the card)."""
    rng = np.random.default_rng() if rng is None else rng
    if p % block_length != 0:
        raise ValueError(f"block_length ({block_length}) does not divide p ({p})")
    if not (0 < prob < 1):
        raise ValueError(f"transition probability must be in (0,1), got {prob}")
    blocks = p // block_length
    vals = np.zeros((n, p), np.uint8)
    for b in range(blocks):
        # pool of haplotypes: first allele ~ Bernoulli(1/2), then sticky walk
        while True:
            h = np.zeros((hap, block_length), np.uint8)
            h[:, 0] = rng.integers(0, 2, size=hap)
            for j in range(1, block_length):
                stay = rng.random(hap) < prob
                h[:, j] = np.where(stay, h[:, j - 1], 1 - h[:, j - 1])
            if np.all(h.sum(axis=1) > 0):
                break
        r1 = rng.integers(0, hap, size=n)
        r2 = rng.integers(0, hap, size=n)
        vals[:, b * block_length:(b + 1) * block_length] = h[r1] + h[r2]
    return _finish(s, _values_to_codes(vals), device)


def adhoc_add_correlation(codes: np.ndarray, rho: float, pos: int, location,
                          rng=None):
    """Copy SNP `pos` into SNPs in `location` with probability rho per sample
    (reference src/simulate_utilities.jl:339-348). Operates on an (n, p) code
    matrix in place; 0-based indices."""
    rng = np.random.default_rng() if rng is None else rng
    if not (0 <= rho <= 1):
        raise ValueError(f"correlation coefficient must be in (0, 1), got {rho}")
    n = codes.shape[0]
    for loc in np.atleast_1d(location):
        mask = rng.random(n) < rho
        codes[mask, loc] = codes[mask, pos]
    return codes


def make_snparray(s, values, device=None) -> PackedGenotypes:
    """Pack an additive-value matrix {0,1,2} (np.nan = missing) into
    PackedGenotypes on ``device`` (default the card), optionally writing a
    PLINK .bed at path `s` (reference export `make_snparray`,
    src/MendelIHT.jl:31, backed by _make_snparray
    src/simulate_utilities.jl:85-101)."""
    vals = np.asarray(values)
    if np.issubdtype(vals.dtype, np.floating):
        miss = np.isnan(vals)
        codes = _values_to_codes(np.where(miss, 0, vals).astype(np.uint8))
        codes[miss] = 1
    else:
        codes = _values_to_codes(vals.astype(np.uint8))
    return _finish(s, codes, device)


def make_bim_fam_files(x, y, name: str):
    """Write `.bim`/`.fam` companions for a simulated .bed (reference
    src/simulate_utilities.jl:360-383): y (n,) or (n, traits) in .fam
    columns 6 onward, each value as ``str`` writes it (a float64 or float32
    reads back as the same number)."""
    n, p = x.shape
    y = np.asarray(y)
    if y.shape[0] != n:
        raise ValueError(f"phenotype has length {y.shape[0]} but genotypes "
                         f"have {n} samples")
    with open(name + ".bim", "w") as f:
        f.writelines(f"1\tsnp{i}\t0\t{100 * i}\t1\t2\n"
                     for i in range(1, p + 1))
    traits = 1 if y.ndim == 1 else y.shape[1]
    ymat = y.reshape(n, traits)
    with open(name + ".fam", "w") as f:
        for i in range(1, n + 1):
            f.write(f"{i}\t1\t0\t0\t1")
            for j in range(traits):
                f.write(f"\t{ymat[i - 1, j]}")
            f.write("\n")
