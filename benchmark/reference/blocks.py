"""The plain reference in rank blocks: each rank of a sharded cell decodes
only its own SNP rows, with the frozen decode and its own counts, and the
reference (``iht.py``, run whole and unchanged on every rank) sees the
whole matrix through two collectives of ``torch.distributed``:

- ``xtr``: the rank's (B, p_local) block of X' R, all-gathered into the
  whole (B, p);
- ``forward``: X[:, idx] coef summed over the columns the rank owns, then
  all-reduced.

It imports nothing of the program: not its operator, not its mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import iht


class ShardGenotypes:
    """The standardized n x p matrix of which this rank holds the SNP rows
    [lo, lo + per) (``words`` (per/4, n4), SNPs past p zero words), with
    the interface ``iht.py`` uses of ``iht.Genotypes`` (``n``, ``p``,
    ``dtype``, ``words``, ``has_missing``, ``xtr`` and ``forward``).  ``group`` holds the ranks whose rows make up the matrix,
    in the order of their rows; every one of them makes the same calls."""

    def __init__(self, words: torch.Tensor, n: int, p: int, lo: int,
                 group, dtype):
        self.local = iht.Genotypes(words, n, 4 * words.shape[0], dtype)
        self.words, self.n, self.p, self.dtype = words, n, p, dtype
        self.lo, self.per, self.group = lo, 4 * words.shape[0], group
        anywhere = torch.tensor([int(self.local.has_missing)],
                                device=words.device)
        dist.all_reduce(anywhere, group=group)
        self.has_missing = bool(anywhere.item() > 0)
        self.local.has_missing = self.has_missing

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """X' R for R (B, n) -> (B, p)."""
        block = self.local.xtr(R).contiguous()
        parts = [torch.empty_like(block)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, block, group=self.group)
        return torch.cat(parts, dim=1)[:, :self.p]

    def forward(self, idx: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
        """X[:, idx] coef per task: idx, coef (B, K) -> (B, n), each rank
        decoding only the columns it owns."""
        lidx, own = self._owned(idx)
        b, k = torch.nonzero(own, as_tuple=True)
        out = torch.zeros((idx.shape[0], self.n), dtype=self.dtype,
                          device=self.words.device)
        if b.numel():
            cols = self.local.columns(lidx[b, k][None, :])[0]
            out.index_add_(0, b, cols * coef[b, k][:, None].to(self.dtype))
        dist.all_reduce(out, group=self.group)
        return out

    def _owned(self, idx):
        """(local index, 0 where not owned; owned) of global SNP indices."""
        lidx = idx - self.lo
        own = (lidx >= 0) & (lidx < self.per)
        return torch.where(own, lidx, torch.zeros_like(lidx)), own


def prepare_blocks(ref):
    """The class that prepares the genotypes of the reference module
    ``ref`` in rank blocks (called as ``(words, n, p, lo, group, dtype)``),
    or None where it cannot run in them: the module's own
    ``prepare_blocks``, else ``ShardGenotypes`` for a module that prepares
    ``iht.Genotypes``.  A reference module added later over genotypes of
    its own says here, by its own attribute, how it runs in rank blocks,
    since no file of the benchmark is edited to add one."""
    own = getattr(ref, "prepare_blocks", None)
    if own is not None:
        return own
    return ShardGenotypes if ref.prepare is iht.Genotypes else None
