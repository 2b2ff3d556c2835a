"""Packed 2-bit genotype container on one torch device.

Same storage as the JAX package (``mendeliht_tpu/genotype/snparray.py``), so
both hold identical words for identical codes:

PLINK `.bed` crumb codes, 2 bits per genotype::

    0b00 = homozygous ref  -> additive value 0
    0b01 = missing         -> imputed with the per-SNP mean
    0b10 = heterozygous    -> additive value 1
    0b11 = homozygous alt  -> additive value 2

Bytes are crumb-transposed: for ``n4 = ceil(n/4)`` rounded up to ``_LANE``,
crumb ``s`` of byte ``packed[j, b]`` holds sample ``s*n4 + b`` of SNP ``j``.
The device storage packs four SNPs per int32 word: ``words (ceil(p/4), n4)``,
byte ``k`` of ``words[i, w]`` is byte ``w`` of SNP ``4i+k`` (little-endian).

Standardization (reference SnpLinAlg ``center=true, scale=true,
impute=true``)::

    mu_j  = mean of observed additive values of SNP j
    sd_j  = sqrt(mu_j * (1 - mu_j / 2))     # binomial HWE sd
    x_std = (value_or_imputed - mu_j) / sd_j  # sd_j == 0 -> no scaling

The standardized matrix is never materialized on the device; the score
kernel decodes raw values and applies (mu, 1/sd) algebraically.

The numpy host packers below are copies of the JAX package's, so that this
package never imports it (importing any ``mendeliht_tpu`` module imports jax).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kernels import build_words_t

# samples per crumb plane are padded to a multiple of _LANE bytes; the value
# is the JAX package's, so both packages pad every n to the same n4
_LANE = 512


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _bytes_to_words(packed: np.ndarray) -> np.ndarray:
    """(p, n4) uint8 -> (p4 = ceil(p/4), n4) int32 SNP-quad words: byte ``k``
    of ``words[i, w]`` is byte ``w`` of SNP ``4i+k``.  Rows past p are zero
    bytes (additive value 0, inert).  The explicit '<i4' keeps the layout
    correct on any host."""
    packed = np.ascontiguousarray(packed)
    p, n4 = packed.shape
    p4 = -(-p // 4)
    if p4 * 4 != p:
        packed = np.concatenate(
            [packed, np.zeros((p4 * 4 - p, n4), np.uint8)], axis=0)
    quad = np.ascontiguousarray(
        packed.reshape(p4, 4, n4).transpose(0, 2, 1))        # (p4, n4, 4)
    return quad.view(np.dtype("<i4")).reshape(p4, n4)


def _words_to_bytes(words: np.ndarray, p: int | None = None) -> np.ndarray:
    """Inverse host transform: (p4, n4) int32 quad words -> (p, n4) uint8
    crumb-transposed byte rows."""
    words = np.ascontiguousarray(
        np.asarray(words).astype(np.dtype("<i4"), copy=False))
    p4, n4 = words.shape
    by = words.view(np.uint8).reshape(p4, n4, 4).transpose(0, 2, 1)
    out = np.ascontiguousarray(by).reshape(4 * p4, n4)
    return out if p is None else out[:p]


def pack_codes(codes: np.ndarray, n4: int | None = None) -> np.ndarray:
    """Pack a (p, n) uint8 code matrix (values 0..3) into the crumb-transposed
    (p, n4) uint8 layout. Padding samples are code 0 (additive value 0)."""
    p, n = codes.shape
    if n4 is None:
        n4 = _ceil_to(-(-n // 4), _LANE)
    out = np.zeros((p, n4), dtype=np.uint8)
    for s in range(4):
        lo, hi = s * n4, min((s + 1) * n4, n)
        if lo >= n:
            break
        blk = codes[:, lo:hi].astype(np.uint8)
        out[:, : hi - lo] |= blk << (2 * s)
    return out


def unpack_codes(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_codes` -> (p, n) uint8 codes."""
    planes = [(packed >> (2 * s)) & 0x3 for s in range(4)]
    full = np.concatenate(planes, axis=1)
    return full[:, :n]


def codes_to_values(codes: np.ndarray) -> np.ndarray:
    """Additive values from codes; missing (code 1) -> NaN. float64 output."""
    lut = np.array([0.0, np.nan, 1.0, 2.0])
    return lut[codes]


def _stats_from_counts(n_obs, n_het, n_alt, dtype=np.float64):
    """mu, 1/sd (binomial), maf from per-SNP genotype counts."""
    with np.errstate(invalid="ignore", divide="ignore"):
        mu = np.where(n_obs > 0, (n_het + 2.0 * n_alt) / np.maximum(n_obs, 1), 0.0)
        sd = np.sqrt(np.maximum(mu * (1.0 - mu / 2.0), 0.0))
        inv_sd = np.where(sd > 0, 1.0 / np.where(sd > 0, sd, 1.0), 0.0)
    af = mu / 2.0
    maf_ = np.minimum(af, 1.0 - af)
    return mu.astype(dtype), inv_sd.astype(dtype), maf_.astype(dtype)


@dataclasses.dataclass
class PackedGenotypes:
    """n x p standardized genotype operator backed by 2-bit packed storage
    on one device.  Samples are the logical rows, SNPs the columns
    (``x[i, j]``), though storage is SNP-major."""

    words: torch.Tensor      # (ceil(p/4), n4) int32 SNP-quad words
    mu: torch.Tensor         # (p,) observed mean additive value
    inv_sd: torch.Tensor     # (p,) 1/sd, or 0 where sd == 0
    n: int                   # true sample count
    p: int                   # true SNP count
    has_missing: bool        # skip the missing-plane work when False
    # optional second, score-only layout: the transposed per-SNP words
    # (n4/4, 4*p4) of ops/kernels.build_words_t, built by with_dual_layout;
    # never used for gathers
    words_t: torch.Tensor | None = None

    @property
    def shape(self):
        return (self.n, self.p)

    @property
    def n_pad(self) -> int:
        return 4 * self.words.shape[1]

    @property
    def device(self) -> torch.device:
        return self.words.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mu.dtype

    def __repr__(self):
        return (f"PackedGenotypes(n={self.n}, p={self.p}, "
                f"words={tuple(self.words.shape)} int32, "
                f"has_missing={self.has_missing}, device={self.device})")

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_numpy(cls, words: np.ndarray, mu, inv_sd, *, n: int, p: int,
                   has_missing: bool, device,
                   dtype=torch.float32) -> "PackedGenotypes":
        """Take host quad words plus per-SNP stats (e.g. the JAX package's
        ``np.asarray(g.words)``, ``np.asarray(g.mu)``, ``np.asarray(g.inv_sd)``)
        onto ``device``."""
        words = np.ascontiguousarray(
            np.asarray(words).astype(np.dtype("<i4"), copy=False))
        if not words.flags.writeable:       # e.g. a view of a JAX array
            words = words.copy()
        if words.ndim != 2 or words.shape[0] != -(-p // 4):
            raise ValueError(f"words {words.shape} do not hold p={p} SNPs")
        if 4 * words.shape[1] < n:
            raise ValueError(f"words {words.shape} do not hold n={n} samples")
        return cls(
            words=torch.from_numpy(words.view(np.int32)).to(device),
            mu=torch.tensor(np.asarray(mu), dtype=dtype, device=device),
            inv_sd=torch.tensor(np.asarray(inv_sd), dtype=dtype,
                                device=device),
            n=int(n), p=int(p), has_missing=bool(has_missing))

    @classmethod
    def from_codes(cls, codes: np.ndarray, *, device, sample_major: bool = True,
                   dtype=torch.float32) -> "PackedGenotypes":
        """Build from a dense uint8 code matrix (values 0..3).
        ``sample_major=True`` means codes is (n, p) like the reference's
        univariate x."""
        if sample_major:
            codes = np.ascontiguousarray(codes.T)
        codes = codes.astype(np.uint8, copy=False)
        p, n = codes.shape
        n_het = (codes == 2).sum(axis=1)
        n_alt = (codes == 3).sum(axis=1)
        n_mis = (codes == 1).sum(axis=1)
        mu, inv_sd, _ = _stats_from_counts(n - n_mis, n_het, n_alt)
        return cls.from_numpy(
            _bytes_to_words(pack_codes(codes)), mu.astype(np.float32),
            inv_sd.astype(np.float32), n=n, p=p,
            has_missing=bool(n_mis.sum() > 0), device=device, dtype=dtype)

    @classmethod
    def from_packed(cls, packed: np.ndarray, mu, inv_sd, *, n: int, p: int,
                    has_missing: bool, device,
                    dtype=torch.float32) -> "PackedGenotypes":
        """Build from an already crumb-transposed (p, n4) uint8 byte matrix
        with precomputed per-SNP stats."""
        return cls.from_numpy(
            _bytes_to_words(np.asarray(packed)),
            np.asarray(mu, np.float32), np.asarray(inv_sd, np.float32),
            n=n, p=p, has_missing=has_missing, device=device, dtype=dtype)

    def with_dual_layout(self) -> "PackedGenotypes":
        """Attach the transposed per-SNP word view (score-only layout, on the
        words' device) and return self.  Idempotent, and deliberately in
        place, as in the JAX package: repeated operator builds on the same
        genotypes must share one ``words_t``, since a copy per build would
        hold another packed matrix of device memory each."""
        if self.words_t is None:
            self.words_t = build_words_t(self.words, self.p)
        return self

    # -- host-side dense views (tests / small problems) --------------------
    def packed_np(self) -> np.ndarray:
        """(p, n4) uint8 host byte rows of the quad-word storage."""
        return _words_to_bytes(self.words.cpu().numpy(), self.p)

    def to_codes(self) -> np.ndarray:
        """(n, p) uint8 codes (sample-major)."""
        return unpack_codes(self.packed_np(), self.n).T

    def to_dense_standardized(self, dtype=np.float64) -> np.ndarray:
        """Materialize the (n, p) standardized, mean-imputed matrix on the
        host (small problems / correctness oracles only)."""
        vals = codes_to_values(self.to_codes())                  # NaN = missing
        mu = self.mu.cpu().double().numpy()[None, :]
        inv = self.inv_sd.cpu().double().numpy()[None, :]
        vals = np.where(np.isnan(vals), mu, vals)
        return ((vals - mu) * np.where(inv == 0, 1.0, inv)).astype(dtype)
