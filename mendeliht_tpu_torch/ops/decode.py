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
"""

from __future__ import annotations

import torch

# quad rows x n4 words decoded per chunk of the plain score: bounds the
# decoded float temporaries to ~32 MB each whatever the matrix size
_CHUNK_WORDS = 1 << 21


def _plane_val_miss(crumbs: torch.Tensor, dtype, want_missing: bool):
    """(..., n4) uint8 codes of one shift plane -> value, missing or None,
    hi bit, hi&lo bit, each as ``dtype``."""
    hi = crumbs >> 1
    hl = hi & crumbs & 1
    hi_f = hi.to(dtype)
    hl_f = hl.to(dtype)
    miss = (crumbs & 1).to(dtype) - hl_f if want_missing else None
    return hi_f + hl_f, miss, hi_f, hl_f


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


def _xt_dots_rows(row_bytes, p4: int, rhs: torch.Tensor, want_missing: bool,
                  want_sq: bool, p: int | None):
    """Raw-plane dots of 4*p4 SNP byte rows against ``rhs`` (4*n4, m), chunk
    by chunk: ``row_bytes(lo, hi)`` gives the (4*(hi-lo), n4) uint8 rows of
    SNPs 4*lo..4*hi-1, so no (p, n_pad) float matrix is ever materialized."""
    n4 = rhs.shape[0] // 4
    m = rhs.shape[1]
    p_out = 4 * p4 if p is None else p
    planes = rhs.reshape(4, n4, m)
    dtype = rhs.dtype
    kw = dict(dtype=dtype, device=rhs.device)
    A = torch.empty((4 * p4, m), **kw)
    M = torch.empty((4 * p4, m), **kw) if want_missing else None
    S = torch.empty((4 * p4, m), **kw) if want_sq else None
    chunk = max(1, _CHUNK_WORDS // max(n4, 1))
    for lo in range(0, p4, chunk):
        hi = min(lo + chunk, p4)
        by = row_bytes(lo, hi)                               # (4c, n4) u8
        rows = slice(4 * lo, 4 * hi)
        a = torch.zeros((4 * (hi - lo), m), **kw)
        mm = torch.zeros_like(a) if want_missing else None
        ss = torch.zeros_like(a) if want_sq else None
        for s in range(4):
            crumbs = (by >> (2 * s)) & 3
            val, miss, hi_f, hl_f = _plane_val_miss(crumbs, dtype, want_missing)
            a += val @ planes[s]
            if want_missing:
                mm += miss @ planes[s]
            if want_sq:
                ss += (hi_f + 3.0 * hl_f) @ planes[s]
        A[rows] = a
        if want_missing:
            M[rows] = mm
        if want_sq:
            S[rows] = ss
    return (A[:p_out], M[:p_out] if want_missing else None,
            S[:p_out] if want_sq else None)


def xt_dots_words(words: torch.Tensor, rhs: torch.Tensor, *,
                  want_missing: bool, want_sq: bool = False,
                  p: int | None = None):
    """Raw-plane dots of the whole packed matrix against ``rhs``.

    words (p4, n4) int32; rhs (n_pad = 4*n4, m) float.  Returns (A, M, S):
    value dot (p, m), missing dot (p, m) or None, squared-value dot (p, m)
    or None, with p = 4*p4 unless ``p`` slices off the quad-padding rows.

    Chunked over quad rows (like the JAX package's ``decode.xt_dots``) so
    that no (p, n_pad) float matrix is ever materialized."""
    return _xt_dots_rows(lambda lo, hi: quad_rows_bytes(words[lo:hi]),
                         words.shape[0], rhs, want_missing, want_sq, p)


def xt_dots_words_t(words_t: torch.Tensor, rhs: torch.Tensor, *,
                    want_missing: bool, want_sq: bool = False,
                    p: int | None = None):
    """``xt_dots_words`` over the transposed per-SNP words: words_t
    (nw = n4/4, 4*p4) int32, rhs (16*nw, m).  Same outputs, the contract of
    ``mendeliht_tpu.ops.pallas_kernels.xt_dots_words_t`` (a NaN in an rhs
    column is NaN in that output column).  Chunked over SNP columns, each
    chunk viewed back as byte rows."""
    return _xt_dots_rows(
        lambda lo, hi: t_rows_bytes(words_t[:, 4 * lo:4 * hi]),
        words_t.shape[1] // 4, rhs, want_missing, want_sq, p)


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
        val, miss, _, _ = _plane_val_miss(crumbs, dtype, want_missing)
        xb_s = torch.einsum("bjn,bj->bn", val, coef)
        if want_missing:
            xb_s = xb_s + torch.einsum("bjn,bj->bn", miss, mus)
        out.append(xb_s)
    return torch.cat(out, dim=1)
