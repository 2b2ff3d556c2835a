"""Sparsity projections: batched top-k hard threshold over ``[b; c]``.

Reference semantics (src/utilities.jl:533-559): ``project_k!`` keeps the k
largest-magnitude entries of the concatenated ``[b; c]`` vector, with
``zkeep``-pinned covariates forced in by a +inf magnitude; surviving entries
keep their original values.  ``torch.topk`` does not promise which of two
equal magnitudes it keeps, where the JAX package keeps the lower index
(ROADMAP Queue 3): the selected value multiset is the same.
"""

from __future__ import annotations

import torch


def joint_magnitude(b, c, zkeep):
    """|[b;c]| with +inf pinning of kept covariates.
    b (B,p), c (B,q), zkeep (q,) bool -> (B, p+q)."""
    mag = torch.cat([b, c], dim=1).abs()
    pin = torch.cat([torch.zeros(b.shape[1], dtype=torch.bool,
                                 device=b.device), zkeep])
    return torch.where(pin[None, :], torch.full_like(mag, float("inf")), mag)


def project_topk_joint(b, c, k_plus_keep, zkeep, S: int):
    """Batched joint top-k projection.

    Keeps the ``k_plus_keep[t]`` largest entries (by pinned magnitude) of
    each task's ``[b; c]``; everything else is zeroed, except ``zkeep``
    covariates which always keep their value.

    Returns (b_new, c_new, sel_idx (B,S), sel_val (B,S), sel_keep (B,S));
    ``sel_idx`` indexes the concatenated vector and padding slots have
    ``sel_keep == False``."""
    p = b.shape[1]
    mag = joint_magnitude(b, c, zkeep)
    _, topi = torch.topk(mag, S, dim=1)                          # (B, S)
    full = torch.cat([b, c], dim=1)
    vals = torch.gather(full, 1, topi)
    rank = torch.arange(S, device=b.device)[None, :]
    keep = rank < k_plus_keep[:, None]
    kept_vals = torch.where(keep, vals, torch.zeros_like(vals))
    new_full = torch.zeros_like(full).scatter_(1, topi, kept_vals)
    pin = torch.cat([torch.zeros(p, dtype=torch.bool, device=b.device),
                     zkeep])[None, :]
    new_full = torch.where(pin, full, new_full)
    sel_keep = keep & (vals != 0)
    return new_full[:, :p], new_full[:, p:], topi, vals, sel_keep


def select_support(b, c, zkeep, S: int):
    """Top-S support of an (already sparse) [b;c]: returns sel_idx,
    sel_valid.  Valid = nonzero entry (reference idx = b .!= 0)."""
    mag = joint_magnitude(b, c, zkeep)
    _, topi = torch.topk(mag, S, dim=1)
    vals = torch.gather(torch.cat([b, c], dim=1), 1, topi)
    return topi, vals != 0
