"""2-bit genotype decode + fused products: the plain PyTorch versions.

These are the reference versions of the hand-written kernels in
``ops/kernels.py``: the CPU path runs them, the tests hold them against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.

Layout (genotype/snparray.py): ``words (p4, n4)`` int32, byte ``k`` of
``words[i, w]`` is byte ``w`` of SNP ``4i+k``, and crumb ``s`` of that byte is
sample ``s*n4 + w``, so shift-plane ``s`` is the contiguous sample block
``[s*n4, (s+1)*n4)``.  The transposed dual layout ``words_t (n4/4, 4*p4)``
(``ops/kernels.build_words_t``) holds bytes ``4w..4w+3`` of SNP ``j``'s byte
row in word ``(w, j)``.

Decode algebra per crumb code c (hi = c>>1, lo = c&1):
    raw value (missing -> 0):  v  = hi + (hi & lo)      in {0,1,2}
    missing indicator:         m  = lo & ~hi
    squared value:             v² = hi + 3*(hi & lo)    in {0,1,4}

Standardized products are assembled outside the heavy pass:
    X_std' R = inv_sd ∘ (A + mu ∘ M - mu · colsum(R)),   A = Vraw'R, M = Miss'R

The two score kernels' plain versions, ``xt_dots_words`` over the quad
words and ``xt_dots_words_t`` over the transposed words, are the JAX
package's digit-plane function (``pallas_kernels.xt_dots_words`` and
``.xt_dots_words_t``): R split into three int8 digit planes, exact integer
sums of the decoded value, missing and hi-bit planes against them, an f32
combine and a NaN guard.  On the same genotypes the two are equal bit for
bit.  A float64 R takes the float64 digit score instead: eight int8 digits
of 7 bits (56 >= 53 bits, ``quantize_rhs_planes64``), their exact sums
combined in float64 (``combine_digits64``), the score of a float64 fit on
the card.  ``xt_dots`` is the function with R unquantised, in R's dtype,
the counterpart of the JAX package's ``decode.xt_dots``, which its
operator runs off the TPU; the port's operator runs it on the CPU.

The kernel lab's versions (``tools/kernel_lab5.py``): ``xt_dots_T``, A
through three int8 digit planes of R with exact integer sums, and the
narrow-integer probes ``unpack_words`` / ``int_dot_packed``.

The round-3 kernel probe's versions (``tools/kernel_probe.py``): the same A
over the retired row-major layout ``words (p, nw)`` in 16 decode rounds
(``xt_i8_rounds``), which is ``words_t.T``: crumb ``s`` of byte ``b`` of word
``(j, w)`` is sample ``s*4nw + 4w + b`` of SNP ``j``; and the streaming-read
and decode-only probes ``stream_xor`` / ``decode_only``.
"""

from __future__ import annotations

import torch

# quad rows x n4 words decoded per chunk of the plain scores: bounds the
# decoded float temporaries to ~32 MB (f32) or ~64 MB (float64) each
# whatever the matrix size
_CHUNK_WORDS = 1 << 21


def _plane_val_miss(crumbs: torch.Tensor, dtype, want_missing: bool):
    """(..., n4) uint8 codes of one shift plane -> value (missing -> 0) and
    missing indicator or None, each as ``dtype``: from the code c as a
    float, value max(c - 1, 0) and missing c == 1, exact."""
    c = crumbs.to(dtype)
    val = torch.clamp(c - 1.0, min=0.0)
    return val, (c == 1.0).to(dtype) if want_missing else None


def quad_rows_bytes(words: torch.Tensor) -> torch.Tensor:
    """(c, n4) int32 quad words -> (4c, n4) uint8 byte rows, row 4i+k = SNP
    4i+k (the little-endian byte view of each word)."""
    c, n4 = words.shape
    by = words.contiguous().view(torch.uint8).reshape(c, n4, 4)
    return by.permute(0, 2, 1).reshape(4 * c, n4)


def t_rows_bytes(words_t: torch.Tensor) -> torch.Tensor:
    """(nw, c) int32 transposed words -> (c, 4*nw) uint8 byte rows, row j =
    SNP column j (word (w, j) holds bytes 4w..4w+3 of that row)."""
    nw, c = words_t.shape
    return words_t.T.contiguous().view(torch.uint8).reshape(c, 4 * nw)


def quad_rows(words: torch.Tensor):
    """The ``row_bytes`` of the quad words (p4, n4): SNPs lo..hi-1, lo and
    hi multiples of 4, as (hi - lo, n4) uint8 byte rows."""
    return lambda lo, hi: quad_rows_bytes(words[lo // 4:hi // 4])


def t_rows(words_t: torch.Tensor):
    """The ``row_bytes`` of the transposed words (nw, p_all): SNP columns
    lo..hi-1 as (hi - lo, 4*nw) uint8 byte rows."""
    return lambda lo, hi: t_rows_bytes(words_t[:, lo:hi])


def _chunk_snps(n4: int) -> int:
    """SNPs a chunk of the plain scores: the byte rows of ``_CHUNK_WORDS``
    quad words, a multiple of 4."""
    return 4 * max(1, _CHUNK_WORDS // max(n4, 1))


def xt_dots(words: torch.Tensor, rhs: torch.Tensor, *, want_missing: bool,
            want_sq: bool = False, p: int | None = None):
    """Raw-plane dots of the whole packed matrix against ``rhs`` in its
    dtype (f32 or float64), R unquantised: the counterpart of the JAX
    package's ``decode.xt_dots`` (which takes the byte rows), run by the
    operator on the CPU.

    words (p4, n4) int32; rhs (n_pad = 4*n4, m) float.  Returns (A, M, S):
    value dot (p, m), missing dot (p, m) or None, squared-value dot (p, m)
    or None, with p = 4*p4 unless ``p`` slices off the quad-padding rows.

    Chunked over quad rows (like the JAX package's ``decode.xt_dots``) so
    that no (p, n_pad) float matrix is ever materialized."""
    row_bytes = quad_rows(words)
    n4 = rhs.shape[0] // 4
    m = rhs.shape[1]
    p_all = 4 * words.shape[0]
    p_out = p_all if p is None else p
    planes = rhs.reshape(4, n4, m)
    kw = dict(dtype=rhs.dtype, device=rhs.device)
    wanted = (True, want_missing, want_sq)
    outs = [torch.empty((p_all, m), **kw) if w else None for w in wanted]
    chunk = _chunk_snps(n4)
    for lo in range(0, p_all, chunk):
        hi = min(lo + chunk, p_all)
        by = row_bytes(lo, hi)                               # (c, n4) u8
        acc = [torch.zeros((hi - lo, m), **kw) if w else None for w in wanted]
        for s in range(4):
            val, miss = _plane_val_miss((by >> (2 * s)) & 3, rhs.dtype,
                                        want_missing)
            sq = val * val if want_sq else None
            for a, x in zip(acc, (val, miss, sq)):
                if a is not None:
                    a += x @ planes[s]
        for o, a in zip(outs, acc):
            if o is not None:
                o[lo:hi] = a
    return tuple(None if o is None else o[:p_out] for o in outs)


def quantize_rhs_planes(rhs: torch.Tensor):
    """f32 (n_pad, m) -> ((3m, n_pad) int8 digit planes [hi|mid|lo], (m,)
    f32 per-column scale), bit for bit the JAX package's
    ``pallas_kernels._quantize_rhs_planes``.

    r ~= scale * (hi*16384 + mid*128 + lo), every digit in [-64, 64]; an
    all-zero column gets scale 2^-20 and zero digits.  Rounding is half to
    even, as ``jnp.round``.  A NaN/Inf column gives meaningless digits."""
    rhs_t = rhs.t().to(torch.float32)                      # (m, n_pad)
    mx = rhs_t.abs().amax(dim=1)
    scale = torch.where(mx > 0, mx, torch.ones_like(mx)) / (1 << 20)
    r = torch.round(rhs_t / scale[:, None]).to(torch.int32)
    rh = torch.round(r.to(torch.float32) * (1.0 / 16384.0)).to(torch.int32)
    rm = torch.round((r - rh * 16384).to(torch.float32) * (1.0 / 128.0)
                     ).to(torch.int32)
    rl = r - rh * 16384 - rm * 128
    return torch.cat([rh, rm, rl], dim=0).to(torch.int8), scale


# the float64 digit score: DIGITS64 digits of 7 bits a column, most
# significant first, each in [-64, 64]; a column's largest |R| maps to
# 2^55, so r = R / scale keeps all 53 bits of every entry
DIGITS64 = 8
_TOP64 = 7 * (DIGITS64 - 1) + 6


def quantize_rhs_planes64(rhs: torch.Tensor):
    """float64 (n_pad, m) -> ((8m, n_pad) int8 digit planes, row ``d*m +
    c`` digit d of column c, most significant first; (m,) float64 scale).

    ``scale = max|R_col| / 2^55`` (2^-55 for an all-zero column), r =
    round_half_even(R / scale) as int64 (|r| <= 2^55, exact: R has 53
    bits), then the digits of r in base 128 by exact int64 arithmetic:
    the top digit r / 2^49 rounded to nearest (ties up), then each
    remainder's, the last the units, so ``r = sum_d 128^(7-d) digit_d``
    exactly and every digit is in [-64, 64].  A column with a NaN or Inf
    gets zero digits (its scores are NaN through :func:`nan_guard64`), so
    the digits are defined on every device."""
    rhs_t = rhs.t().to(torch.float64)                      # (m, n_pad)
    finite = torch.isfinite(rhs_t).all(dim=1, keepdim=True)
    rhs_t = torch.where(finite, rhs_t, torch.zeros_like(rhs_t))
    mx = rhs_t.abs().amax(dim=1)
    scale = torch.where(mx > 0, mx, torch.ones_like(mx)) * 2.0 ** -_TOP64
    r = torch.round(rhs_t / scale[:, None]).to(torch.int64)
    digits = []
    for d in range(DIGITS64):
        shift = 7 * (DIGITS64 - 1 - d)
        q = (r + (1 << shift >> 1)) >> shift if shift else r
        digits.append(q)
        r = r - (q << shift)
    return torch.cat(digits, dim=0).to(torch.int8), scale


def combine_digits64(sums: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    """(p, 8, m) exact digit sums (digit d of column c at ``[:, d, c]``, any
    integer or float dtype that holds them exactly, any strides) -> (p, m)
    float64 scores: Horner from the top digit, ``acc = 128*acc + sum_d``
    (the product by 128 exact, one rounding a step), then ``* scale``.
    Elementwise in one fixed order, so equal digit sums give equal scores
    bit for bit on any device."""
    acc = sums[:, 0].to(torch.float64)
    for d in range(1, sums.shape[1]):
        acc = acc * 128.0 + sums[:, d]
    return acc * scale[None, :]


def nan_guard64(rhs: torch.Tensor) -> torch.Tensor:
    """(m,) float64 ``rhs.sum(0) * 0``: the float64 :func:`nan_guard`."""
    return rhs.to(torch.float64).sum(dim=0) * 0.0


def digit_sums(row_bytes, p_all: int, planes: torch.Tensor, *,
               want_missing: bool = False, want_sq: bool = False):
    """Exact integer dots of decoded genotypes against int8 digit rows:
    ``row_bytes(lo, hi)`` gives the (hi - lo, n4) uint8 byte rows of SNPs
    lo..hi-1 (:func:`quad_rows`, :func:`t_rows`; lo and hi multiples of 4,
    or hi = p_all), planes (rows, 4*n4) int8 -> (V'D, Miss'D or None, H'D
    or None), each (p_all, rows) float64 holding the int32 sums exactly: V
    the crumb values (missing -> 0), Miss the missing indicators, H the hi
    bits (``V^2 = 3V - 2H``).

    Each product is at most 128 in magnitude, so every partial sum is an
    integer below 2^53 and float64 keeps it exact; chunked over SNPs so no
    (p, n_pad) matrix is made."""
    rows, n_pad = planes.shape
    n4 = n_pad // 4
    d = planes.to(torch.float64).reshape(rows, 4, n4)
    kw = dict(dtype=torch.float64, device=planes.device)
    wanted = (True, want_missing, want_sq)
    outs = [torch.empty((p_all, rows), **kw) if w else None for w in wanted]
    chunk = _chunk_snps(n4)
    for lo in range(0, p_all, chunk):
        hi = min(lo + chunk, p_all)
        by = row_bytes(lo, hi)                               # (c, n4) u8
        acc = [torch.zeros((hi - lo, rows), **kw) if w else None
               for w in wanted]
        for q in range(4):
            val, miss = _plane_val_miss((by >> (2 * q)) & 3, torch.float64,
                                        want_missing)
            hi_f = (val > 0.0).to(torch.float64) if want_sq else None
            dq = d[:, q].T
            for a, x in zip(acc, (val, miss, hi_f)):
                if a is not None:
                    a += x @ dq
        for o, a in zip(outs, acc):
            if o is not None:
                o[lo:hi] = a
    return tuple(outs)


def digit_sums_t(words_t: torch.Tensor, planes: torch.Tensor, *,
                 want_missing: bool = False, want_sq: bool = False):
    """:func:`digit_sums` over the transposed words (nw, p_all): planes
    (rows, 16*nw) -> each (p_all, rows) float64."""
    return digit_sums(t_rows(words_t), words_t.shape[1], planes,
                      want_missing=want_missing, want_sq=want_sq)


def digit_dots_t(words_t: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """The value sums V'D of :func:`digit_sums_t`: (p_all, rows) float64."""
    return digit_sums_t(words_t, planes)[0]


def combine_digits(sums: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(p, 3m) exact digit sums [hi|mid|lo] -> (p, m) f32 scores: each sum
    rounded to f32 as the int32 accumulator is, then ``(16384*hi + 128*mid
    + lo) * scale`` in that f32 order (one rounding a step)."""
    m = scale.shape[0]
    a = sums.to(torch.float32)
    return (16384.0 * a[:, :m] + 128.0 * a[:, m:2 * m]
            + a[:, 2 * m:]) * scale[None, :]


def nan_guard(rhs: torch.Tensor) -> torch.Tensor:
    """(m,) f32 ``rhs.sum(0) * 0``: NaN where a column is not finite (its
    digits are meaningless), else 0, added to every output of the digit
    scores so a failed column stays failed."""
    return (rhs.sum(dim=0) * 0.0).to(torch.float32)


def _digit_score(row_bytes, p_all: int, rhs: torch.Tensor, *,
                 want_missing: bool, want_sq: bool, p: int | None):
    """The digit-plane score of both layouts: (A, M, S) of the SNPs' byte
    rows (``row_bytes``, :func:`digit_sums`) against ``rhs``: f32, or the
    float64 digit score (:func:`_digit_score64`) where ``rhs`` is float64.

    R is split into three int8 digit planes (:func:`quantize_rhs_planes`);
    the value, missing and hi-bit sums against them are exact and combined
    in f32 (:func:`combine_digits`); ``S = 3A - 2H``; every output adds
    :func:`nan_guard`, so a NaN or Inf in an rhs column is NaN in that
    output column and nowhere else.  ``p`` slices off the quad-padding SNPs
    (default: keep them; they are zero)."""
    if rhs.dtype == torch.float64:
        return _digit_score64(row_bytes, p_all, rhs, want_missing=want_missing,
                              want_sq=want_sq, p=p)
    planes, scale = quantize_rhs_planes(rhs)
    guard = nan_guard(rhs)[None, :]
    a, mm, h = digit_sums(row_bytes, p_all, planes,
                          want_missing=want_missing, want_sq=want_sq)
    A = combine_digits(a, scale)
    M = combine_digits(mm, scale) if want_missing else None
    S = 3.0 * A - 2.0 * combine_digits(h, scale) if want_sq else None
    p_out = A.shape[0] if p is None else p
    return tuple(None if o is None else (o + guard)[:p_out] for o in (A, M, S))


def digit_outputs64(a, mm, h, scale, guard, p: int | None):
    """(A, M, S) float64 of the exact digit sums of the value, missing and
    hi-bit planes (each (p_all, 8, m) or None): :func:`combine_digits64`,
    ``S = 3A - 2H``, every output plus ``guard`` (:func:`nan_guard64`), cut
    to ``p`` SNPs (default all).  The plain version and the card's
    float64 entries both end here."""
    A = combine_digits64(a, scale)
    M = combine_digits64(mm, scale) if mm is not None else None
    S = 3.0 * A - 2.0 * combine_digits64(h, scale) if h is not None else None
    p_out = A.shape[0] if p is None else p
    return tuple(None if o is None else (o + guard[None, :])[:p_out]
                 for o in (A, M, S))


def digit_sums64(row_bytes, p_all: int, rhs: torch.Tensor, *,
                 want_missing: bool, want_sq: bool):
    """The exact sums of the float64 digit score: ((V'D, Miss'D or None,
    H'D or None), scale), each sum (p_all, 8, m) float64 with digit d of
    column c at ``[:, d, c]``, D the digits of
    :func:`quantize_rhs_planes64` (:func:`digit_sums`)."""
    planes, scale = quantize_rhs_planes64(rhs)
    sums = digit_sums(row_bytes, p_all, planes, want_missing=want_missing,
                      want_sq=want_sq)
    return tuple(None if x is None else x.view(p_all, DIGITS64, -1)
                 for x in sums), scale


def _digit_score64(row_bytes, p_all: int, rhs: torch.Tensor, *,
                   want_missing: bool, want_sq: bool, p: int | None):
    """The float64 digit score of both layouts: R in eight int8 digits
    (:func:`quantize_rhs_planes64`), the value, missing and hi-bit sums
    against them exact (:func:`digit_sums64`), combined in float64
    (:func:`digit_outputs64`)."""
    sums, scale = digit_sums64(row_bytes, p_all, rhs,
                               want_missing=want_missing, want_sq=want_sq)
    return digit_outputs64(*sums, scale, nan_guard64(rhs), p)


def xt_dots_words(words: torch.Tensor, rhs: torch.Tensor, *,
                  want_missing: bool, want_sq: bool = False,
                  p: int | None = None):
    """Raw-plane dots over the quad words through int8 digit planes of R:
    words (p4, n4) int32, rhs (4*n4, m) float.  Returns (A, M, S) like
    :func:`xt_dots`, f32: the function of ``mendeliht_tpu.ops.
    pallas_kernels.xt_dots_words`` (:func:`_digit_score`), equal bit for
    bit to :func:`xt_dots_words_t` on the same genotypes' transposed
    words; float64 for a float64 rhs (the float64 digit score)."""
    return _digit_score(quad_rows(words), 4 * words.shape[0], rhs,
                        want_missing=want_missing, want_sq=want_sq, p=p)


def xt_dots_words_t(words_t: torch.Tensor, rhs: torch.Tensor, *,
                    want_missing: bool, want_sq: bool = False,
                    p: int | None = None):
    """Raw-plane dots over the transposed per-SNP words through int8 digit
    planes of R: words_t (nw = n4/4, p_all) int32, rhs (16*nw, m) float.
    Returns (A, M, S) like :func:`xt_dots`, f32: the function of
    ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words_t``
    (:func:`_digit_score`); float64 for a float64 rhs."""
    return _digit_score(t_rows(words_t), words_t.shape[1], rhs,
                        want_missing=want_missing, want_sq=want_sq, p=p)


def xt_dots_T(words_t: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The value dots A = V'R over the transposed words through int8 digit
    planes of R: words_t (nw, p_all) int32, rhs (16*nw, m) f32 -> (p_all, m)
    f32.  The contract of ``tools/kernel_lab5.py::xt_dots_T``: A only, no
    NaN re-poisoning, missing crumbs count 0.  Each exact digit sum is
    rounded to f32 as the int32 accumulator is, then combined as
    ``(16384*hi + 128*mid + lo) * scale`` in that f32 order."""
    planes, scale = quantize_rhs_planes(rhs)
    return combine_digits(digit_dots_t(words_t, planes), scale)


def rounds_restride(planes: torch.Tensor, nw: int, tw: int | None = None):
    """(rows, n_pad = 16*nw) digit planes -> (16, rows, nw_pad) in the
    round-3 probe's order: round ``r = 4b + s`` holds, at word ``w``, the
    digit of sample ``s*4nw + 4w + b``; word columns past nw (to a multiple
    of ``tw``, default nw) are zero.  ``tools/kernel_probe.py::
    rounds_restride``."""
    rows, n_pad = planes.shape
    if n_pad != 16 * nw:
        raise ValueError(f"planes {tuple(planes.shape)} do not hold 16*nw = "
                         f"{16 * nw} samples")
    tw = nw if tw is None else tw
    nw_pad = -(-nw // tw) * tw
    r = planes.reshape(rows, 4, nw, 4).permute(3, 1, 0, 2).reshape(16, rows, nw)
    if nw_pad != nw:
        r = torch.cat([r, r.new_zeros((16, rows, nw_pad - nw))], dim=2)
    return r


def _round_shifts():
    """Bit offset of round r's crumb in a word: crumb s = r % 4 of byte
    b = r // 4."""
    return [2 * (r % 4) + 8 * (r // 4) for r in range(16)]


def _recode(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> every crumb's value in {0, 1, 2} (missing -> 0),
    h + (h & t) with h = (t >> 1) & 0x55555555, in wrapping int32."""
    h = (t >> 1) & 0x55555555
    return h + (h & t)


def xt_i8_rounds(words: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The value dots A = V'R over the round-3 row-major words through int8
    digit planes of R: words (p, nw) int32, rhs (16*nw, m) f32 -> (p, m)
    f32.  The contract of ``tools/kernel_probe.py::xt_i8_rounds``: A only,
    missing crumbs count 0, the result independent of its tiles.

    Round r decodes one crumb of every word and dots it with round r of
    :func:`rounds_restride`; the integer sums are exact in float64, rounded
    to f32 and combined as ``(16384*hi + 128*mid + lo) * scale``, as
    :func:`xt_dots_T`, so ``xt_i8_rounds(W, R)`` equals ``xt_dots_T(W.T,
    R)`` bit for bit.  Chunked over SNP rows."""
    p, nw = words.shape
    planes, scale = quantize_rhs_planes(rhs)
    m = scale.shape[0]
    rr = rounds_restride(planes, nw).to(torch.float64)        # (16, 3m, nw)
    acc = torch.empty((p, 3 * m), dtype=torch.float64, device=words.device)
    chunk = max(1, _CHUNK_WORDS // max(nw, 1))
    for lo in range(0, p, chunk):
        w = _recode(words[lo:lo + chunk])
        a = torch.zeros((w.shape[0], 3 * m), dtype=torch.float64,
                        device=words.device)
        for r, shift in enumerate(_round_shifts()):
            a += ((w >> shift) & 3).to(torch.float64) @ rr[r].T
        acc[lo:lo + chunk] = a
    return combine_digits(acc, scale)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of x over its first dimension (a tree of halvings)."""
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
        h = x.shape[0] // 2
        x = x[:h] ^ x[h:]
    return x[0]


def _xor_tiles(words: torch.Tensor, seed: torch.Tensor, tp: int, tw: int,
               f) -> torch.Tensor:
    """(tp, tw) int32: the XOR over every (tp, tw) tile of ``f(words +
    seed)`` (wrapping int32).  Rows and word columns past the array are
    absent and contribute nothing, so a ragged last tile is defined.
    Chunked over whole row tiles."""
    p, nw = words.shape
    s = seed.reshape(()).to(torch.int32)
    ct = -(-nw // tw)
    out = torch.zeros((tp, tw), dtype=torch.int32, device=words.device)
    rows = max(1, 2 * _CHUNK_WORDS // max(tp * nw, 1)) * tp
    for lo in range(0, p, rows):
        v = f(words[lo:lo + rows] + s)
        rt = -(-v.shape[0] // tp)
        buf = torch.zeros((rt * tp, ct * tw), dtype=torch.int32,
                          device=words.device)
        buf[:v.shape[0], :nw] = v
        tiles = buf.reshape(rt, tp, ct, tw).permute(0, 2, 1, 3)
        out ^= _xor_reduce(tiles.reshape(rt * ct, tp, tw))
    return out


def stream_xor(words: torch.Tensor, seed: torch.Tensor, tp: int
               ) -> torch.Tensor:
    """The streaming-read probe: words (p, nw) int32, seed (1, 1) int32 ->
    (tp, nw) int32, row r the XOR of ``words[i*tp + r] + seed`` over the
    row tiles i (``tools/kernel_probe.py::stream_xor``).  Rows past p are
    absent (the reference leaves them undefined on a ragged last tile)."""
    return _xor_tiles(words, seed, tp, words.shape[1], lambda t: t)


def decode_sums(t: torch.Tensor) -> torch.Tensor:
    """Per int32 word, the sum of its 16 crumb values in the probe's round
    order (``_kernel_decode_only``)."""
    w = _recode(t)
    acc = torch.zeros_like(t)
    for shift in _round_shifts():
        acc += (w >> shift) & 3
    return acc


def decode_only(words: torch.Tensor, seed: torch.Tensor, tp: int, tw: int
                ) -> torch.Tensor:
    """The decode-only probe: words (p, nw) int32, seed (1, 1) int32 ->
    (tp, tw) int32, the XOR over every (tp, tw) tile of the 16-crumb value
    sums of ``words + seed`` (``tools/kernel_probe.py::decode_only``).  Rows
    and word columns past the array are absent; the reference's result
    agrees where tp divides p and tw divides nw."""
    return _xor_tiles(words, seed, tp, tw, decode_sums)


def unpack_words(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(r, c) int32 -> (32/bits * r, c) int32: each word split into its
    ``bits``-wide fields, sign-extended, in ``pltpu.bitcast``'s word-major
    order (output row ``k*i + j`` is field ``j`` of row ``i``, low field
    first, k = 32/bits)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k = 32 // bits
    fields = [(x << (32 - bits * (j + 1))) >> (32 - bits) for j in range(k)]
    return torch.stack(fields, dim=1).reshape(k * x.shape[0], x.shape[1])


def check_contraction(ka: int, kb: int):
    """Raise ``jax.lax.dot_general``'s TypeError for contracting dimensions
    ``ka`` and ``kb`` that differ."""
    if ka != kb:
        raise TypeError("dot_general requires contracting dimensions to have "
                        f"the same shape, got ({ka},) and ({kb},).")


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of integer matrices a (M, K) and b (K, N); the
    contraction of ``jax.lax.dot_general`` with an int32 result, and its
    shape error.  Through float64, exact while every sum is below 2^53."""
    check_contraction(a.shape[1], b.shape[0])
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def int_dot_packed(x_words: torch.Tensor, y: torch.Tensor, bits: int,
                   lhs_packed: bool = True) -> torch.Tensor:
    """The lab's packed-operand dot: the ``bits``-wide fields of x_words
    (``unpack_words``) against y cast to int8 (wrapping, as ``astype``),
    as the left operand (``lhs_packed``) or the right one."""
    xs, ys = unpack_words(x_words, bits), y.to(torch.int8)
    return int_dot(xs, ys) if lhs_packed else int_dot(ys, xs)


def read_words(words: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c + sum(words)`` in wrapping int32, as a (1,) int32 tensor: the
    read-bandwidth probe's result (``mendeliht_tpu.utils.profiling.
    _pallas_reader`` returns the same sum as a (1, 1) int32)."""
    s = words.sum(dtype=torch.int64) + c.to(torch.int64)
    return ((s + 2**31) % 2**32 - 2**31).to(torch.int32).reshape(1)


def take_rows_bytes(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather SNP rows from the quad-word storage -> (B, S, n4) uint8.

    SNP j lives in byte ``j % 4`` of quad row ``j // 4``: a contiguous row
    gather followed by a per-row byte select, so only the small (B*S, n4)
    gathered block is ever decoded."""
    B, S = idx.shape
    flat = idx.reshape(-1).long()
    g = words[flat // 4]                                     # (B*S, n4) int32
    shift = ((flat % 4) * 8).to(torch.int32)[:, None]
    return ((g >> shift) & 0xFF).to(torch.uint8).reshape(B, S, words.shape[1])


def gather_decode_rows(rows: torch.Tensor, dtype, *, want_missing: bool):
    """Decode gathered SNP rows (B, S, n4) uint8 -> raw values (B, S, 4*n4)
    and the missing plane (or None without ``want_missing``), in sample
    order (``mendeliht_tpu.ops.decode.gather_decode_rows``)."""
    vals, misses = [], []
    for s in range(4):
        val, miss = _plane_val_miss((rows >> (2 * s)) & 3, dtype,
                                    want_missing)
        vals.append(val)
        misses.append(miss)
    return (torch.cat(vals, dim=2),
            torch.cat(misses, dim=2) if want_missing else None)


def sparse_forward_rows(rows: torch.Tensor, idx: torch.Tensor,
                        coef: torch.Tensor, mu: torch.Tensor, *,
                        want_missing: bool) -> torch.Tensor:
    """Raw sparse forward product plus missing correction.

    rows (B, S, n4) gathered byte rows; idx (B, S) SNP indices; coef (B, S)
    already scaled by inv_sd and masked (invalid slots carry coef == 0).
    Returns (B, 4*n4): ``sum_j coef[b,j] * (v_raw[:, idx] + mu*miss[:, idx])``.
    The caller subtracts the constant ``sum_j coef[b,j]*mu[idx[b,j]]``."""
    dtype = coef.dtype
    mus = mu[idx] * coef                                     # (B, S)
    out = []
    for s in range(4):
        crumbs = (rows >> (2 * s)) & 3
        val, miss = _plane_val_miss(crumbs, dtype, want_missing)
        xb_s = torch.einsum("bjn,bj->bn", val, coef)
        if want_missing:
            xb_s = xb_s + torch.einsum("bjn,bj->bn", miss, mus)
        out.append(xb_s)
    return torch.cat(out, dim=1)


def sparse_forward_rows_multi(rows: torch.Tensor, idx: torch.Tensor,
                              coef: torch.Tensor, mu: torch.Tensor, *,
                              want_missing: bool) -> torch.Tensor:
    """Multi-trait raw sparse forward product (multivariate IHT).

    rows (B, S, n4) gathered byte rows; idx (B, S) SNP indices shared by
    the traits; coef (B, R, S) per-trait coefficients already scaled by
    inv_sd and masked.  Returns (B, R, 4*n4): each selected row is decoded
    once and contracted against all R traits
    (``mendeliht_tpu.ops.decode.sparse_forward_rows_multi``).  The caller
    subtracts the constant ``sum_j coef[b,r,j]*mu[idx[b,j]]``."""
    dtype = coef.dtype
    mus = mu[idx][:, None, :] * coef                         # (B, R, S)
    out = []
    for s in range(4):
        crumbs = (rows >> (2 * s)) & 3
        val, miss = _plane_val_miss(crumbs, dtype, want_missing)
        xb_s = torch.einsum("bsn,brs->brn", val, coef)
        if want_missing:
            xb_s = xb_s + torch.einsum("bsn,brs->brn", miss, mus)
        out.append(xb_s)
    return torch.cat(out, dim=2)


def sparse_forward_raw_multi(words: torch.Tensor, idx: torch.Tensor,
                             coef: torch.Tensor, mu: torch.Tensor, *,
                             want_missing: bool) -> torch.Tensor:
    """:func:`sparse_forward_rows_multi` of the rows ``idx`` gathered from
    the quad words (``take_rows_bytes``)."""
    return sparse_forward_rows_multi(take_rows_bytes(words, idx), idx, coef,
                                     mu, want_missing=want_missing)
