"""Inputs of a cell, made from ``--seed``: genotype words on the card,
their per-SNP statistics, the phenotypes and the cv folds.

The genotypes are written straight into the port's quad-word layout (the
``PackedGenotypes`` storage: ``words (ceil(p/4), n4)`` int32, byte ``k`` of
``words[i, w]`` is SNP ``4i+k``, crumb ``s`` of that byte is sample
``s*n4 + w``; ``n4 = ceil(n/4)`` rounded up to 512 bytes), a chunk of SNPs
at a time, from a ``torch.Generator`` on the card.  No (n, p) matrix is
ever on the host.  Codes are uniform random crumbs; the configuration's
``genotypes.missing_calls`` is the share of missing calls, 0 (01 recoded
to 00, as in the reference's benchmark simulations) or 0.25 (uniform
codes, 01 kept), and any other share is refused.  Samples past n are code
00.

mu and 1/sd follow the reference's formula (SnpArrays' center/scale with
the binomial sd, over the observed calls) in float64 on the host, from
per-SNP counts taken on the card.  The phenotypes are drawn by the model
of the configuration's family, ``phenotypes/<family>.py``, from the
linear predictor X beta + intercept, whose X beta is the benchmark's own
decode of the causal columns (``reference/decode.py``), never the port's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import decode

LANE = 512                 # bytes a crumb plane is padded to (the port's)
CHUNK_WORDS = 1 << 28      # int32 words made at a time (1 GiB)
_LO = 0x55555555           # the low bit of every crumb
_PAIRS = 0x33333333
_NIBBLES = 0x0F0F0F0F


def padded_n4(n: int) -> int:
    return -(-(-(-n // 4)) // LANE) * LANE


def pad_mask(n: int, n4: int, device) -> torch.Tensor:
    """(n4,) int32: the bits of word column w that hold samples < n."""
    w = torch.arange(n4, device=device)
    mask = torch.full((n4,), -1, dtype=torch.int32, device=device)
    for s in range(4):
        crumb = (0x03030303 << (2 * s)) & 0xFFFFFFFF
        clear = torch.tensor(crumb - (1 << 32) if crumb >= 1 << 31 else crumb,
                             dtype=torch.int32, device=device)
        mask = torch.where(s * n4 + w >= n, mask & ~clear, mask)
    return mask


def _crumb_sums(v: torch.Tensor) -> torch.Tensor:
    """(c4, n4) int32 words of crumb values 0..2 -> (4*c4,) int64 sum of
    each SNP's values."""
    v = (v & _PAIRS) + ((v >> 2) & _PAIRS)       # nibble sums 0..4
    v = (v & _NIBBLES) + ((v >> 4) & _NIBBLES)   # byte sums 0..8
    per_byte = [((v >> (8 * k)) & 0xFF).sum(dim=1) for k in range(4)]
    return torch.stack(per_byte, dim=1).reshape(-1)


def value_sums(words: torch.Tensor) -> torch.Tensor:
    """(c4, n4) int32 quad words -> (4*c4,) int64 sum of the additive
    values (00 -> 0, 01 (missing) -> 0, 10 -> 1, 11 -> 2) of each SNP."""
    hi = (words >> 1) & _LO
    return _crumb_sums(hi + (hi & words & _LO))


def missing_counts(words: torch.Tensor) -> torch.Tensor:
    """(c4, n4) int32 quad words -> (4*c4,) int64 missing calls (01) of
    each SNP."""
    return _crumb_sums(words & ~(words >> 1) & _LO)


MISSING_SHARES = (0, 0.25)


def make_words(n: int, p: int, gen: torch.Generator, device,
               missing: float = 0):
    """(words (ceil(p/4), n4) int32 on ``device``, value sums (p,) int64,
    missing calls (p,) int64, both on the host): uniform codes, 01 recoded
    to 00 where ``missing`` is 0 and kept where it is 0.25; padding 00."""
    if missing not in MISSING_SHARES:
        raise ValueError(f"missing_calls {missing!r}: the harness makes "
                         f"only the shares {MISSING_SHARES}")
    n4, p4 = padded_n4(n), -(-p // 4)
    words = torch.empty((p4, n4), dtype=torch.int32, device=device)
    sums = torch.empty((4 * p4,), dtype=torch.int64, device=device)
    miss = torch.zeros((4 * p4,), dtype=torch.int64, device=device)
    mask = pad_mask(n, n4, device)
    rows = max(1, CHUNK_WORDS // n4)
    for lo in range(0, p4, rows):
        hi = min(lo + rows, p4)
        x = torch.randint(0, 256, (hi - lo, n4, 4), dtype=torch.uint8,
                          generator=gen, device=device)
        x = x.view(torch.int32).reshape(hi - lo, n4)
        if not missing:
            x = x & ~((~x >> 1) & _LO)           # 01 -> 00: no missing call
        x &= mask[None, :]
        words[lo:hi] = x
        sums[4 * lo:4 * hi] = value_sums(x)
        if missing:
            miss[4 * lo:4 * hi] = missing_counts(x)
    if 4 * p4 > p:                               # SNPs past p: all 00
        words[-1] &= ~torch.tensor(
            _byte_mask(p - 4 * (p4 - 1)), dtype=torch.int32, device=device)
    return words, sums[:p].cpu().numpy(), miss[:p].cpu().numpy()


def _byte_mask(keep: int) -> int:
    """int32 value with every bit of bytes keep..3 set."""
    m = 0
    for k in range(keep, 4):
        m |= 0xFF << (8 * k)
    return m - (1 << 32) if m >= 1 << 31 else m


def standardization(sums: np.ndarray, n: int, n_missing=None):
    """mu and 1/sd in float64 (reference: mu = mean additive value over the
    observed calls, sd = sqrt(mu (1 - mu/2)), 1/sd = 0 where sd = 0)."""
    obs = n - (np.zeros_like(sums) if n_missing is None else n_missing)
    mu = np.where(obs > 0, sums.astype(np.float64) / np.maximum(obs, 1), 0.0)
    sd = np.sqrt(np.maximum(mu * (1.0 - mu / 2.0), 0.0))
    inv_sd = np.where(sd > 0, 1.0 / np.where(sd > 0, sd, 1.0), 0.0)
    return mu, inv_sd


@dataclasses.dataclass
class Problem:
    """A cell's inputs: genotype words on the card with their float64
    statistics and missing calls a SNP, the traffic's ``inputs``
    phenotypes (host float64) with their causal SNPs and effects, and one
    fold assignment each where the traffic asks for folds."""
    n: int
    p: int
    words: torch.Tensor
    mu: np.ndarray
    inv_sd: np.ndarray
    n_missing: np.ndarray
    ys: list
    causal: list
    betas: list
    folds: list

    @property
    def has_missing(self) -> bool:
        return bool(self.n_missing.sum() > 0)


def phenotype_model(config: dict):
    """``phenotypes/<family>.py`` of the configuration, after checking
    that it draws the configuration's link."""
    import importlib
    family, link = config["family"], config["link"]
    try:
        mod = importlib.import_module(f"benchmark.phenotypes.{family}")
    except ModuleNotFoundError:
        raise ValueError(f"no phenotype model for the family {family!r} "
                         f"(benchmark/phenotypes/{family}.py)") from None
    if link not in mod.LINKS:
        raise ValueError(f"phenotypes/{family}.py draws the links "
                         f"{mod.LINKS}, not {link!r}")
    return mod


def make_problem(config: dict, traffic: dict, seed: int, device) -> Problem:
    """The inputs of one run from ``seed``: the genotypes of ``config``
    (n, p, missing share) on ``device``, then ``traffic["inputs"]``
    phenotypes over ``config["phenotype"]["causal"]`` SNPs each, with
    effects of the fixed magnitudes ``effect_sizes`` and random signs (the
    same set of sizes for every seed), drawn by the family's model from X
    beta + intercept, and as many fold assignments (``q`` of the call's
    arguments, drawn as cv_iht draws them) where ``traffic["folds"]``."""
    n, p = int(config["n"]), int(config["p"])
    model = phenotype_model(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    words, sums, n_missing = make_words(
        n, p, gen, device, config["genotypes"]["missing_calls"])
    mu, inv_sd = standardization(sums, n, n_missing)
    ph = config["phenotype"]
    sizes = np.asarray(effect_sizes(int(ph["causal"])))
    rng = np.random.default_rng([int(seed), 1])
    ys, causal, betas, folds = [], [], [], []
    for _ in range(int(traffic["inputs"])):
        idx = np.sort(rng.choice(p, size=len(sizes), replace=False))
        beta = rng.permutation(sizes) * rng.choice([-1.0, 1.0], len(sizes))
        eta = (decode.x_beta(words, idx, beta, n, mu, inv_sd)
               + float(ph["intercept"]))
        ys.append(model.draw(eta, rng, ph))
        causal.append(idx)
        betas.append(beta)
        if traffic.get("folds"):
            q = int(traffic["args"]["q"])
            folds.append(rng.integers(1, q + 1, size=n))
    return Problem(n, p, words, mu, inv_sd, n_missing, ys, causal, betas,
                   folds)


def effect_sizes(k: int) -> list:
    """k effect magnitudes: the quantiles (i + 1/2)/k of |N(0, 1)|."""
    from statistics import NormalDist
    z = NormalDist()
    return [z.inv_cdf(0.5 + (i + 0.5) / (2 * k)) for i in range(k)]
