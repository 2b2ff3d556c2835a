"""Genotype operator: standardized products over 2-bit packed genotypes.

All batched ops use a leading task axis B (1 for a single fit).  The score
``xtr`` goes through ``ops.kernels.xt_dots_words``, which the tensors'
device dispatches: the hand-written CUDA kernel on the card, the plain
PyTorch version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from . import decode, kernels
from ..genotype.snparray import PackedGenotypes


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

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """Standardized X' R for R (B, n_pad) -> (B, p)."""
        g = self.geno
        A, M, _ = kernels.xt_dots_words(g.words, R.T, want_missing=g.has_missing,
                                        p=g.p)
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
    """Wrap a design matrix in its operator (packed genotypes only, so far)."""
    if isinstance(x, PackedOp):
        return x
    if isinstance(x, PackedGenotypes):
        return PackedOp(x)
    raise NotImplementedError(
        f"design matrix type {type(x).__name__} is not ported yet: "
        "ROADMAP Queue 1 item 4 (DenseOp) / item 13 (streamed genotypes)")
