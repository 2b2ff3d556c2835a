"""Genotype operator: standardized products over 2-bit packed genotypes.

All batched ops use a leading task axis B (1 for a single fit).  The score
``xtr`` is routed as the JAX package routes it (``mendeliht_tpu/ops/
linalg.py::PackedOp._xt_dots``): on the card, to ``ops.kernels.
xt_dots_words_t`` (kernel 2) where the genotypes carry the transposed dual
layout and the RHS is at most ``_VT_MAX_M`` wide, else to ``ops.kernels.
xt_dots_words`` (kernel 1), as the JAX package picks its Pallas kernels on
a TPU; on the CPU, whatever the layout, to the f32 function
``ops.decode.xt_dots``, as the JAX package runs its oracle
``decode.xt_dots`` off the TPU.

``DenseOp`` holds a dense (n, p) f32 design matrix (a VCF or BGEN file's
standardized dosages, or a caller's matrix) and computes the same products
with ``torch.matmul`` / ``einsum`` in full f32, as the JAX package's
``DenseOp`` does at ``Precision.HIGHEST``.

Every operator has a dtype, float32 or float64, the dtype of its fit: a
PackedOp's per-SNP statistics are cast to it (the words are shared), a
DenseOp's matrix is in it, and its products come back in it.  A float64
score on the card runs kernels 1 and 2's float64 entries (the exact
float64 digit score); on the CPU ``decode.xt_dots`` in float64.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from . import decode, kernels
from ..genotype.snparray import PackedGenotypes
from ..utils.device import float_dtype, resolve_device

# the JAX package's values and overrides: the widest RHS routed to the
# transposed layout when it is stored, and the packed-bytes budget under
# which make_operator stores it (0 disables the dual layout)
_VT_MAX_M = 4096
_DUAL_MAX_BYTES = 3 * 2**30


def _env_int(name: str, default: int) -> int:
    """The integer override ``name`` from the environment, else ``default``;
    a malformed value raises (the JAX package falls back to the default)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def transposed_score(g: PackedGenotypes, m: int) -> bool:
    """Whether the card's score of an RHS m wide runs on the transposed
    words (kernel 2) rather than the quad words (kernel 1): where ``words_t``
    is stored and m is at most ``MENDELIHT_VT_MAX_M`` (default
    ``_VT_MAX_M``)."""
    return (g.words_t is not None
            and m <= _env_int("MENDELIHT_VT_MAX_M", _VT_MAX_M))


@dataclasses.dataclass
class PackedOp:
    """The standardized operator of PackedGenotypes in ``dtype`` (None:
    the genotypes' own): ``mu`` and ``inv_sd`` are the genotypes' cast to
    it, and every product is in it."""
    geno: PackedGenotypes
    dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.dtype is None:
            self.dtype = self.geno.mu.dtype
        self.mu = self.geno.mu.to(self.dtype)
        self.inv_sd = self.geno.inv_sd.to(self.dtype)

    @property
    def n(self):
        return self.geno.n

    @property
    def p(self):
        return self.geno.p

    @property
    def n_pad(self):
        return self.geno.n_pad

    @property
    def device(self):
        return self.geno.device

    def _xt_dots(self, RT: torch.Tensor, want_sq: bool = False):
        """Raw dots (A, M, S) of the whole matrix against RT (n_pad, m): on
        the CPU the unquantised function in RT's dtype, else the score
        kernel that :func:`transposed_score` picks (its float64 entry for a
        float64 RT)."""
        g = self.geno
        kw = dict(want_missing=g.has_missing, want_sq=want_sq, p=g.p)
        if RT.device.type == "cpu":
            return decode.xt_dots(g.words, RT, **kw)
        if transposed_score(g, RT.shape[1]):
            return kernels.xt_dots_words_t(g.words_t, RT, **kw)
        return kernels.xt_dots_words(g.words, RT, **kw)

    def _rows_bytes(self, idx: torch.Tensor) -> torch.Tensor:
        """The byte rows (B, S, n4) uint8 of the SNPs idx (B, S)."""
        return decode.take_rows_bytes(self.geno.words, idx)

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """Standardized X' R for R (B, n_pad) -> (B, p)."""
        g = self.geno
        A, M, _ = self._xt_dots(R.T)
        colsum = R.sum(dim=1)                                  # (B,)
        corr = M - colsum[None, :] if g.has_missing else -colsum[None, :]
        out = self.inv_sd[:, None] * (A + self.mu[:, None] * corr)
        return out.T

    def forward_sel(self, idx: torch.Tensor, coef: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """Standardized X[:, idx] @ coef -> (B, n_pad).

        idx (B, S) SNP indices; coef (B, S); valid (B, S) 0/1.  Invalid slots
        are ignored regardless of index value."""
        g = self.geno
        coef_s = coef * self.inv_sd[idx] * valid
        rows = self._rows_bytes(idx)
        raw = decode.sparse_forward_rows(rows, idx, coef_s, self.mu,
                                         want_missing=g.has_missing)
        const = (coef_s * self.mu[idx]).sum(dim=1)             # (B,)
        return raw - const[:, None]

    def forward_sel_multi(self, idx: torch.Tensor, coef: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
        """Multi-trait standardized forward product: idx (B, S) SNP
        indices shared by the traits, coef (B, R, S), valid (B, S) 0/1 ->
        (B, R, n_pad); each selected row decoded once for all R traits."""
        g = self.geno
        coef_s = coef * (self.inv_sd[idx] * valid)[:, None, :]
        rows = self._rows_bytes(idx)
        raw = decode.sparse_forward_rows_multi(rows, idx, coef_s, self.mu,
                                               want_missing=g.has_missing)
        const = (coef_s * self.mu[idx][:, None, :]).sum(dim=2)  # (B, R)
        return raw - const[:, :, None]

    def gather_cols(self, idx: torch.Tensor, valid: torch.Tensor):
        """Standardized columns X[:, idx] -> (B, S, n_pad), invalid slots
        zeroed: the debias refit's small design (plain torch ops, as XLA
        runs the JAX package's ``PackedOp.gather_cols``)."""
        g = self.geno
        rows = self._rows_bytes(idx)
        val, miss = decode.gather_decode_rows(rows, self.dtype,
                                              want_missing=g.has_missing)
        mu = self.mu[idx][:, :, None]
        inv = self.inv_sd[idx][:, :, None]
        if g.has_missing:
            val = val + mu * miss
        return (val - mu) * inv * valid[:, :, None]

    def col_moments(self, W: torch.Tensor, WY: torch.Tensor):
        """Per-SNP weighted moments of the standardized columns, W and WY
        (B, n_pad) -> Sx, Sxx, Sxy, each (B, p):
        ``Sx = sum_i w_i x_ij``, ``Sxx = sum_i w_i x_ij^2``,
        ``Sxy = sum_i (wy)_i x_ij``.

        One score pass at width 2B with the squared plane S (and M where
        the genotypes miss calls): on the card kernel 2 (or kernel 1), whose
        int8 digits carry a 0/1 W exactly and quantise the WY columns to 21
        bits against their max (56 in a float64 operator); on the CPU the
        unquantised ``decode.xt_dots``."""
        g = self.geno
        B = W.shape[0]
        R = torch.stack([W, WY], dim=0).reshape(2 * B, -1)   # (2B, n_pad)
        A, M, Sq = self._xt_dots(R.T, want_sq=True)
        A = A.T.reshape(2, B, -1)
        Sq = Sq.T.reshape(2, B, -1)
        M = M.T.reshape(2, B, -1) if g.has_missing else torch.zeros_like(A)
        mu, inv = self.mu[None, :], self.inv_sd[None, :]
        sumW = W.sum(dim=1)[:, None]
        sumWY = WY.sum(dim=1)[:, None]
        Sx = inv * (A[0] + mu * (M[0] - sumW))
        Sxy = inv * (A[1] + mu * (M[1] - sumWY))
        # Sxx = inv^2 (Sq_w - 2 mu A_w - mu^2 M_w + mu^2 sumW)
        Sxx = inv * inv * (Sq[0] - 2.0 * mu * A[0] - mu * mu * M[0]
                           + mu * mu * sumW)
        return Sx, Sxx, Sxy


@contextlib.contextmanager
def full_f32():
    """f32 matrix products in full f32 inside, whatever the caller set
    (``torch.set_float32_matmul_precision("high")`` or ``allow_tf32`` lets
    cuBLAS round the operands to TF32, and oneDNN may do the like on a
    CPU); the caller's settings are restored after."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    old = [b.fp32_precision for b in backends]
    for b in backends:
        b.fp32_precision = "ieee"
    try:
        yield
    finally:
        for b, o in zip(backends, old):
            b.fp32_precision = o


# bytes of gathered (tasks, S, n) columns a forward product makes at a
# time: a multivariate cv chunk at k = 1,000 gathers 15 x 1,001 x n
_GATHER_BYTES = 1 << 30


@dataclasses.dataclass
class DenseOp:
    """A dense (n, p) f32 or float64 design matrix, used as it is (the
    caller standardizes), on its own device; ``n_pad = n``.  Its products
    run in its dtype (``full_f32`` keeps TF32 out of the f32 ones)."""
    x: torch.Tensor

    @property
    def n(self):
        return self.x.shape[0]

    @property
    def p(self):
        return self.x.shape[1]

    @property
    def n_pad(self):
        return self.x.shape[0]

    @property
    def dtype(self):
        return self.x.dtype

    @property
    def device(self):
        return self.x.device

    def _by_tasks(self, idx, fn):
        """``fn(cols, lo, hi)`` over the tasks of idx (B, S) in chunks whose
        gathered columns ``x[:, idx[lo:hi]]`` (hi - lo, S, n) hold at most
        ``_GATHER_BYTES``; the results joined on the task axis."""
        B, S = idx.shape
        step = max(1, _GATHER_BYTES // max(1, S * self.n
                                           * self.x.element_size()))
        xt = self.x.T
        outs = [fn(xt[idx[lo:lo + step]], lo, lo + step)
                for lo in range(0, B, step)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """X' R for R (B, n) -> (B, p)."""
        with full_f32():
            return R @ self.x

    def forward_sel(self, idx, coef, valid):
        """X[:, idx] @ coef -> (B, n); idx, coef, valid (B, S)."""
        w = coef * valid
        with full_f32():
            return self._by_tasks(idx, lambda cols, lo, hi: torch.einsum(
                "bjn,bj->bn", cols, w[lo:hi]))

    def forward_sel_multi(self, idx, coef, valid):
        """idx (B, S), coef (B, R, S), valid (B, S) -> (B, R, n)."""
        w = coef * valid[:, None, :]
        with full_f32():
            return self._by_tasks(idx, lambda cols, lo, hi: torch.einsum(
                "bsn,brs->brn", cols, w[lo:hi]))

    def gather_cols(self, idx, valid):
        """Columns X[:, idx] -> (B, S, n), invalid slots zeroed."""
        return self.x.T[idx] * valid[:, :, None]

    def col_moments(self, W, WY):
        """W and WY (B, n) -> Sx = W X, Sxx = W X², Sxy = WY X, each (B, p)."""
        with full_f32():
            return W @ self.x, W @ (self.x * self.x), WY @ self.x


def make_operator(x, dtype=None):
    """Wrap a design matrix in its operator, in ``dtype`` (float32 or
    float64, the fit's, as the JAX package's ``make_operator(x, dtype)``;
    None: genotypes keep their statistics' dtype, a dense matrix becomes
    f32).

    A PackedOp (a StreamedPackedOp among them) or DenseOp is returned as
    it is where it is in ``dtype``, else as an operator of the same kind
    over the same genotypes or matrix in ``dtype``: that is how a caller
    runs the quad-word kernel on genotypes without ``words_t``.
    HostStreamedGenotypes (out of core) get a ``StreamedPackedOp``.
    Genotypes on a CUDA device get the transposed dual layout, in place,
    where their packed words fit ``MENDELIHT_DUAL_MAX_BYTES`` (default
    ``_DUAL_MAX_BYTES``), as the JAX package stores it on a TPU; CPU
    genotypes never get it here.  A dense matrix becomes a DenseOp: a
    torch tensor on its own device, a numpy array on the card (a caller
    who wants the CPU passes a CPU tensor)."""
    if dtype is not None:
        dtype = float_dtype(dtype, "make_operator")
    if isinstance(x, DenseOp):
        return x if dtype in (None, x.dtype) else DenseOp(x.x.to(dtype))
    if isinstance(x, PackedOp):
        return x if dtype in (None, x.dtype) else type(x)(x.geno, dtype)
    if isinstance(x, PackedGenotypes):
        if (x.device.type == "cuda" and x.words_t is None
                and x.words.numel() * 4 <= _env_int(
                    "MENDELIHT_DUAL_MAX_BYTES", _DUAL_MAX_BYTES)):
            x.with_dual_layout()
        return PackedOp(x, dtype)
    dense = torch.float32 if dtype is None else dtype
    if isinstance(x, torch.Tensor):
        return DenseOp(x.to(dense))
    if isinstance(x, np.ndarray):
        return DenseOp(torch.as_tensor(x, dtype=dense,
                                       device=resolve_device()))
    from .streaming import HostStreamedGenotypes, StreamedPackedOp
    if isinstance(x, HostStreamedGenotypes):
        return StreamedPackedOp(x, dtype)
    raise TypeError(f"unsupported design matrix type {type(x)}")
