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
A PLINK ``.bed`` payload is repacked into the quad words by torch ops on the
genotypes' device (:meth:`PackedGenotypes.from_bed_bytes`), and written back
from them the same way (:func:`bed_rows`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kernels import build_words_t
from ..utils.device import float_dtype, resolve_device

# samples per crumb plane are padded to a multiple of _LANE bytes; the value
# is the JAX package's, so both packages pad every n to the same n4
_LANE = 512
# SNPs of .bed rows uploaded and repacked at a time (a multiple of 4, so no
# quad word straddles two chunks): 41 MB of .bed a chunk at n = 10,000
_CHUNK_P = 16384


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


_SHIFTS = (0, 2, 4, 6)          # crumb s of a byte sits at bits 2s, 2s + 1


def _repack_bed_rows(rows: torch.Tensor, n: int, n4: int):
    """``.bed`` rows (c, ceil(n/4)) uint8, sample i of a SNP in crumb i % 4
    of byte i // 4, -> (quad words (ceil(c/4), n4) int32, counts (3, c)
    int64 of codes 10 (het), 11 (alt) and 01 (missing)), on the rows'
    device.  The padding crumbs of each row's last byte are cut before the
    counts; quad rows past c are zero bytes."""
    c, bpr = rows.shape
    planes = torch.stack([(rows >> s) & 3 for s in _SHIFTS], dim=2)
    codes = planes.reshape(c, 4 * bpr)[:, :n]                 # sample order
    counts = torch.stack([(codes == v).sum(dim=1) for v in (2, 3, 1)])
    c4 = -(-c // 4)
    full = torch.zeros((4 * c4, 4 * n4), dtype=torch.uint8,
                       device=rows.device)
    full[:c, :n] = codes
    full = full.view(4 * c4, 4, n4)                # crumb s: samples s*n4+b
    packed = full[:, 0]
    for s in (1, 2, 3):
        packed = packed | (full[:, s] << _SHIFTS[s])
    # byte k of quad word (i, w) is byte w of SNP 4i+k (little-endian)
    quads = packed.view(c4, 4, n4).permute(0, 2, 1).contiguous()
    return quads.view(torch.int32).reshape(c4, n4), counts


def bed_rows(words: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """Inverse of the repack: quad words (ceil(c/4), n4) int32 of c SNPs ->
    their ``.bed`` rows (c, ceil(n/4)) uint8 on the words' device, the
    padding crumbs of each row's last byte zero."""
    c4, n4 = words.shape
    bpr = -(-n // 4)
    packed = words.contiguous().view(torch.uint8).reshape(c4, n4, 4)
    packed = packed.permute(0, 2, 1).reshape(4 * c4, n4)[:c]
    codes = torch.stack([(packed >> s) & 3 for s in _SHIFTS], dim=1)
    codes = codes.reshape(c, 4 * n4)[:, :n]
    full = torch.zeros((c, 4 * bpr), dtype=torch.uint8, device=words.device)
    full[:, :n] = codes
    full = full.view(c, bpr, 4)
    out = full[:, :, 0]
    for s in (1, 2, 3):
        out = out | (full[:, :, s] << _SHIFTS[s])
    return out


def repacked_bed_chunks(bed: np.ndarray, n: int, p: int, device):
    """A raw ``.bed`` payload (p rows of ceil(n/4) bytes) repacked on
    ``device`` ``_CHUNK_P`` SNPs at a time: (lo, hi, quad words (ceil((hi
    - lo)/4), n4) int32, counts (3, hi - lo) int64 of ``_repack_bed_rows``)
    for each chunk of SNPs [lo, hi), so the device holds one chunk of the
    payload at a time."""
    bpr = -(-n // 4)
    bed = np.asarray(bed, np.uint8).reshape(p, bpr)
    n4 = _ceil_to(bpr, _LANE)
    for lo in range(0, p, _CHUNK_P):
        hi = min(lo + _CHUNK_P, p)
        chunk = bed[lo:hi]
        if not chunk.flags.writeable:              # e.g. np.frombuffer's
            chunk = chunk.copy()
        yield (lo, hi) + _repack_bed_rows(torch.from_numpy(chunk).to(device),
                                          n, n4)


def bed_stats(counts: np.ndarray, n: int, dtype, device) -> dict:
    """The per-SNP fields of genotypes from their (3, p) host counts of
    het, alt and missing calls: mu and 1/sd computed in float64 on the
    host (``_stats_from_counts``, as the JAX package computes them) and
    cast to ``dtype`` on ``device``, maf, the missing counts, n, p and
    has_missing."""
    n_het, n_alt, n_mis = counts
    mu, inv_sd, maf_ = _stats_from_counts(n - n_mis, n_het, n_alt)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return dict(mu=torch.from_numpy(mu.astype(np_dtype)).to(device),
                inv_sd=torch.from_numpy(inv_sd.astype(np_dtype)).to(device),
                n=int(n), p=int(counts.shape[1]),
                has_missing=bool(n_mis.sum() > 0), maf_=maf_, n_missing=n_mis)


def bed_chunks(g: "PackedGenotypes"):
    """The ``.bed`` payload of g, ``_CHUNK_P`` SNPs at a time: (c,
    ceil(n/4)) uint8 host arrays, each made on g's device."""
    for lo in range(0, g.p, _CHUNK_P):
        hi = min(lo + _CHUNK_P, g.p)
        yield bed_rows(g.words[lo // 4:-(-hi // 4)], g.n, hi - lo).cpu().numpy()


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
    # host-side minor allele frequencies (float64) and missing calls per
    # SNP where the counts were seen (``from_codes``, ``from_bed_bytes``),
    # else None: ``maf`` then derives the frequencies from mu
    maf_: np.ndarray | None = None
    n_missing: np.ndarray | None = None
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
        onto ``device``, the stats in ``dtype`` (float32 or float64, in any
        spelling ``utils.device.float_dtype`` takes)."""
        dtype = float_dtype(dtype, "PackedGenotypes")
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
    def from_codes(cls, codes: np.ndarray, sample_major: bool = True,
                   dtype=torch.float32, *, device=None) -> "PackedGenotypes":
        """Build from a dense uint8 code matrix (values 0..3) on ``device``
        (default the card, ``utils.device.resolve_device``).
        ``sample_major=True`` means codes is (n, p) like the reference's
        univariate x."""
        device = resolve_device(device)
        if sample_major:
            codes = np.ascontiguousarray(codes.T)
        codes = codes.astype(np.uint8, copy=False)
        p, n = codes.shape
        n_het = (codes == 2).sum(axis=1)
        n_alt = (codes == 3).sum(axis=1)
        n_mis = (codes == 1).sum(axis=1)
        mu, inv_sd, maf_ = _stats_from_counts(n - n_mis, n_het, n_alt)
        g = cls.from_numpy(
            _bytes_to_words(pack_codes(codes)), mu, inv_sd, n=n, p=p,
            has_missing=bool(n_mis.sum() > 0), device=device, dtype=dtype)
        g.maf_, g.n_missing = maf_, n_mis
        return g

    @classmethod
    def from_packed(cls, packed: np.ndarray, mu, inv_sd, *, n: int, p: int,
                    has_missing: bool, dtype=torch.float32,
                    device=None) -> "PackedGenotypes":
        """Build from an already crumb-transposed (p, n4) uint8 byte matrix
        with precomputed per-SNP stats, on ``device`` (default the card)."""
        return cls.from_numpy(
            _bytes_to_words(np.asarray(packed)), mu, inv_sd, n=n, p=p,
            has_missing=has_missing, device=resolve_device(device),
            dtype=dtype)

    @classmethod
    def from_bed_bytes(cls, bed: np.ndarray, n: int, p: int,
                       dtype=torch.float32, *,
                       device=None) -> "PackedGenotypes":
        """Build from a raw PLINK ``.bed`` SNP-major payload (no 3-byte
        header) on ``device`` (default the card): sample ``i`` of SNP ``j``
        sits in crumb ``i % 4`` of byte ``j * ceil(n/4) + i // 4``.

        The payload goes up in chunks of ``_CHUNK_P`` SNPs, each repacked
        there into its quad words beside its genotype counts, so the device
        holds the words and one chunk.  The counts come back as int64 and
        give mu, 1/sd and maf in float64 on the host (``_stats_from_counts``,
        as the JAX package computes them), cast to ``dtype`` after."""
        dtype = float_dtype(dtype, "PackedGenotypes.from_bed_bytes")
        device = resolve_device(device)
        words = torch.zeros((-(-p // 4), _ceil_to(-(-n // 4), _LANE)),
                            dtype=torch.int32, device=device)
        counts = torch.zeros((3, p), dtype=torch.int64, device=device)
        for lo, hi, w, c in repacked_bed_chunks(bed, n, p, device):
            words[lo // 4:lo // 4 + w.shape[0]] = w
            counts[:, lo:hi] = c
        stats = bed_stats(counts.cpu().numpy(), n, dtype, device)
        return cls(words=words, **stats)

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


def maf(x: PackedGenotypes) -> np.ndarray:
    """Minor allele frequency per SNP (reference: SnpArrays.maf, used at
    src/utilities.jl:693): the counts' float64 frequencies where the
    genotypes were built from codes, else min(mu/2, 1 - mu/2) in mu's
    dtype, as the JAX package's ``genotype.snparray.maf``."""
    if x.maf_ is not None:
        return np.asarray(x.maf_)
    af = x.mu.cpu().numpy() / 2.0
    return np.minimum(af, 1.0 - af)


def bed_payload_of_codes(codes: np.ndarray) -> np.ndarray:
    """SNP-major (p, n) uint8 codes -> their ``.bed`` rows (p, ceil(n/4))
    uint8 on the host (the JAX package's numpy packer)."""
    p, n = codes.shape
    bpr = -(-n // 4)
    c = codes.astype(np.uint8)
    if 4 * bpr != n:
        c = np.concatenate([c, np.zeros((p, 4 * bpr - n), np.uint8)], axis=1)
    c = c.reshape(p, bpr, 4)
    shifts = np.arange(4, dtype=np.uint8) * 2
    return np.bitwise_or.reduce((c << shifts[None, None, :]).astype(np.uint8),
                                axis=2)


def naive_impute(x: PackedGenotypes, destination: str | None = None):
    """Impute missing genotypes with the per-SNP mode (reference
    src/utilities.jl:862-899), on the host in chunks of ``_CHUNK_P`` SNPs,
    so no (n, p) code matrix is built.  Returns new genotypes on x's
    device; with ``destination``, also writes them as a PLINK ``.bed``."""
    n, p = x.n, x.p
    bed = np.empty((p, -(-n // 4)), np.uint8)
    for lo in range(0, p, _CHUNK_P):
        hi = min(lo + _CHUNK_P, p)
        words = x.words[lo // 4:-(-hi // 4)].cpu().numpy()
        codes = unpack_codes(_words_to_bytes(words, hi - lo), n)  # (c, n)
        n0 = (codes == 0).sum(axis=1)
        n1 = (codes == 2).sum(axis=1)
        n2 = (codes == 3).sum(axis=1)
        # the mode's code, ties resolved as the reference's if/elseif chain
        most = np.maximum(np.maximum(n0, n1), n2)
        fill = np.where(most == n1, 2, np.where(most == n2, 3, 0))
        out = np.where(codes == 1, fill[:, None].astype(np.uint8), codes)
        bed[lo:hi] = bed_payload_of_codes(out)
    if destination:
        from .plink import write_bed_payload
        write_bed_payload(destination, bed)
    return PackedGenotypes.from_bed_bytes(bed, n, p, device=x.device,
                                          dtype=x.dtype)


def grm(x: PackedGenotypes, method: str = "GRM", chunk: int = 4096,
        device: bool | None = None) -> np.ndarray:
    """Genetic relationship matrix Z Z' / p of the standardized,
    mean-imputed genotypes, (n, n) float64 (reference role: SnpArrays.grm,
    used at test/wrapper_test.jl:123), blocked over ``chunk`` SNPs so the
    dense (n, p) matrix is never built.

    ``device`` None runs on the genotypes' device: on a card, each chunk's
    standardized columns come from ``PackedOp.gather_cols`` and one f32
    product ``Z' Z`` adds them into an (n, n) f32 accumulator there; on the
    CPU, the float64 host loop (the JAX package's ``device=False``).
    ``device`` True or False picks one of the two wherever the genotypes
    are."""
    if method not in ("GRM", "grm"):
        raise ValueError(f"unsupported GRM method {method}")
    if device is None:
        device = x.device.type != "cpu"
    if device:
        return _grm_device(x, chunk)
    n, p = x.n, x.p
    words = x.words.cpu().numpy()
    mu = x.mu.cpu().double().numpy()
    inv = x.inv_sd.cpu().double().numpy()
    inv = np.where(inv == 0, 1.0, inv)
    G = np.zeros((n, n))
    chunk = _ceil_to(chunk, 4)          # quad-word rows hold 4 SNPs each
    for lo in range(0, p, chunk):
        hi = min(lo + chunk, p)
        codes = unpack_codes(
            _words_to_bytes(words[lo // 4:-(-hi // 4)], hi - lo), n)  # (c, n)
        vals = codes_to_values(codes)                            # NaN missing
        m = mu[lo:hi][:, None]
        Z = (np.where(np.isnan(vals), m, vals) - m) * inv[lo:hi][:, None]
        G += Z.T @ Z
    return G / p


def _grm_device(x: PackedGenotypes, chunk: int) -> np.ndarray:
    """The blocked GRM on the genotypes' device: per chunk one
    ``gather_cols`` and one ``Z' Z`` into the resident accumulator, in the
    genotypes' dtype (f32: full f32 products whatever the caller set for
    TF32), one fetch."""
    from ..ops.linalg import PackedOp, full_f32
    op = PackedOp(x)
    n, p = x.n, x.p
    G = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    chunk = max(8, int(chunk))
    with full_f32():
        for lo in range(0, p, chunk):
            idx = torch.arange(lo, min(lo + chunk, p), device=x.device)
            Z = op.gather_cols(idx[None], torch.ones(
                (1, len(idx)), dtype=x.dtype, device=x.device))[0, :, :n]
            G.addmm_(Z.T, Z)
    return G.cpu().double().numpy() / p
