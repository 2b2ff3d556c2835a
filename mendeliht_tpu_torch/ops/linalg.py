"""Genotype operator: standardized products over 2-bit packed genotypes.

All batched ops use a leading task axis B (1 for a single fit).  The score
``xtr`` goes through ``ops.kernels.xt_dots_words`` (quad words) or, where
the genotypes carry the transposed dual layout and the RHS is at most
``_VT_MAX_M`` wide, ``ops.kernels.xt_dots_words_t``, as the JAX package
dispatches (``mendeliht_tpu/ops/linalg.py``).  The tensors' device
dispatches each: the hand-written CUDA kernel on the card, the plain
PyTorch version on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from . import decode, kernels
from ..genotype.snparray import PackedGenotypes

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


@dataclasses.dataclass
class PackedOp:
    geno: PackedGenotypes

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
    def dtype(self):
        return self.geno.mu.dtype

    @property
    def device(self):
        return self.geno.device

    def _xt_dots(self, RT: torch.Tensor, want_sq: bool = False):
        """Raw dots (A, M, S) of the whole matrix against RT (n_pad, m): the
        transposed-layout kernel when ``words_t`` is stored and m is at most
        ``MENDELIHT_VT_MAX_M`` (default ``_VT_MAX_M``), else the quad-word
        kernel."""
        g = self.geno
        kw = dict(want_missing=g.has_missing, want_sq=want_sq, p=g.p)
        if (g.words_t is not None
                and RT.shape[1] <= _env_int("MENDELIHT_VT_MAX_M", _VT_MAX_M)):
            return kernels.xt_dots_words_t(g.words_t, RT, **kw)
        return kernels.xt_dots_words(g.words, RT, **kw)

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """Standardized X' R for R (B, n_pad) -> (B, p)."""
        g = self.geno
        A, M, _ = self._xt_dots(R.T)
        colsum = R.sum(dim=1)                                  # (B,)
        corr = M - colsum[None, :] if g.has_missing else -colsum[None, :]
        out = g.inv_sd[:, None] * (A + g.mu[:, None] * corr)
        return out.T

    def forward_sel(self, idx: torch.Tensor, coef: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """Standardized X[:, idx] @ coef -> (B, n_pad).

        idx (B, S) SNP indices; coef (B, S); valid (B, S) 0/1.  Invalid slots
        are ignored regardless of index value."""
        g = self.geno
        coef_s = coef * g.inv_sd[idx] * valid
        rows = decode.take_rows_bytes(g.words, idx)
        raw = decode.sparse_forward_rows(rows, idx, coef_s, g.mu,
                                         want_missing=g.has_missing)
        const = (coef_s * g.mu[idx]).sum(dim=1)                # (B,)
        return raw - const[:, None]


def make_operator(x):
    """Wrap a design matrix in its operator (packed genotypes only, so far).

    A PackedOp is returned as it is: that is how a caller runs the quad-word
    kernel on genotypes without ``words_t``.  Genotypes on a CUDA device get
    the transposed dual layout, in place, where their packed words fit
    ``MENDELIHT_DUAL_MAX_BYTES`` (default ``_DUAL_MAX_BYTES``), as the JAX
    package stores it on a TPU; CPU genotypes never get it here."""
    if isinstance(x, PackedOp):
        return x
    if isinstance(x, PackedGenotypes):
        if (x.device.type == "cuda" and x.words_t is None
                and x.words.numel() * 4 <= _env_int(
                    "MENDELIHT_DUAL_MAX_BYTES", _DUAL_MAX_BYTES)):
            x.with_dual_layout()
        return PackedOp(x)
    raise NotImplementedError(
        f"design matrix type {type(x).__name__} is not ported yet: "
        "ROADMAP Queue 1 item 4 (DenseOp) / item 13 (streamed genotypes)")
