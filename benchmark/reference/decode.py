"""Frozen copy of the quad-word decode, from
``mendeliht_tpu_torch/ops/decode.py`` (``quad_rows_bytes``,
``take_rows_bytes``, ``gather_decode_rows``, and the value algebra of its
docstring in place of ``_plane_val_miss``), so that the reference never
imports the port.  Changing the port's storage format
needs a new reference, not an edit here.

Layout: ``words (p4, n4)`` int32, byte ``k`` of ``words[i, w]`` is byte
``w`` of SNP ``4i+k`` (little-endian), and crumb ``s`` of that byte is
sample ``s*n4 + w``.  Crumb codes: 00 -> 0, 01 -> missing, 10 -> 1,
11 -> 2.
"""

from __future__ import annotations

import numpy as np
import torch


def quad_rows_bytes(words: torch.Tensor) -> torch.Tensor:
    """(c, n4) int32 quad words -> (4c, n4) uint8 byte rows, row 4i+k = SNP
    4i+k."""
    c, n4 = words.shape
    by = words.contiguous().view(torch.uint8).reshape(c, n4, 4)
    return by.permute(0, 2, 1).reshape(4 * c, n4)


def rows_of(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The byte rows (..., n4) uint8 of the SNPs idx (any shape)."""
    flat = idx.reshape(-1).long()
    g = words[flat // 4]
    shift = ((flat % 4) * 8).to(torch.int32)[:, None]
    rows = ((g >> shift) & 0xFF).to(torch.uint8)
    return rows.reshape(*idx.shape, words.shape[1])


def codes(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Byte rows (..., n4) uint8 -> crumb codes (..., n) uint8 in sample
    order (plane s holds samples s*n4 .. (s+1)*n4 - 1)."""
    planes = [(rows >> (2 * s)) & 3 for s in range(4)]
    return torch.cat(planes, dim=-1)[..., :n]


def values(c: torch.Tensor, dtype, want_missing: bool = True):
    """Codes -> (additive value with missing as 0, missing indicator or
    None), each in ``dtype``: value hi + (hi & lo) = max(c - 1, 0) with hi,
    lo the code's bits, missing c == 1."""
    hi = c >> 1
    v = (hi + (hi & c)).to(dtype)
    return v, (c == 1).to(dtype) if want_missing else None


def x_beta(words: torch.Tensor, idx, beta, n: int, mu: np.ndarray,
           inv_sd: np.ndarray) -> np.ndarray:
    """(n,) float64 host vector X[:, idx] beta of the standardized,
    mean-imputed columns idx (the reference's ``x_std = (value - mu) /
    sd``), decoded and summed on the words' device."""
    kw = dict(dtype=torch.float64, device=words.device)
    idx = np.asarray(idx)
    c = codes(rows_of(words, torch.as_tensor(idx, device=words.device)), n)
    v, miss = values(c, torch.float64)
    m = torch.as_tensor(np.asarray(mu)[idx], **kw)[:, None]
    inv = torch.as_tensor(np.asarray(inv_sd)[idx], **kw)[:, None]
    z = torch.where(miss > 0, torch.zeros_like(v), (v - m) * inv)
    return (torch.as_tensor(np.asarray(beta), **kw) @ z).cpu().numpy()
