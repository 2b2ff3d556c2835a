"""Sparsity projections: batched top-k hard threshold over ``[b; c]`` and the
doubly-sparse group projection.

Reference semantics (src/utilities.jl:533-679):

- ``project_k!`` keeps the k largest-magnitude entries of the concatenated
  ``[b; c]`` vector, where magnitudes are optionally scaled by a prior
  ``weight`` vector and ``zkeep``-pinned covariates are forced in by a +inf
  magnitude; surviving entries keep their original values.
- ``project_group_sparse!`` keeps at most J groups and at most k (or k[g])
  predictors a group, ranking groups by the l2 norm of their top-k entries.

``torch.topk`` does not promise which of two equal magnitudes it keeps,
where the JAX package keeps the lower index (ROADMAP Queue 3): the selected
value multiset is the same.  ``project_k`` and the group projection sort
stably, so they keep the lower index on ties, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch


def joint_magnitude(b, c, zkeep, weight=None):
    """|[b;c]| with weight scaling and +inf pinning of kept covariates.
    b (B,p), c (B,q), zkeep (q,) bool, weight (p+q,) or None -> (B, p+q)."""
    mag = torch.cat([b, c], dim=1).abs()
    if weight is not None:
        mag = mag * weight[None, :]
    pin = torch.cat([torch.zeros(b.shape[1], dtype=torch.bool,
                                 device=b.device), zkeep])
    return torch.where(pin[None, :], torch.full_like(mag, float("inf")), mag)


def project_topk_joint(b, c, k_plus_keep, zkeep, S: int, weight=None):
    """Batched joint top-k projection.

    Keeps the ``k_plus_keep[t]`` largest entries (by pinned, weighted
    magnitude) of each task's ``[b; c]``; everything else is zeroed, except
    ``zkeep`` covariates which always keep their value.

    Returns (b_new, c_new, sel_idx (B,S), sel_val (B,S), sel_keep (B,S));
    ``sel_idx`` indexes the concatenated vector and padding slots have
    ``sel_keep == False``."""
    p = b.shape[1]
    mag = joint_magnitude(b, c, zkeep, weight)
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


def select_support(b, c, zkeep, S: int, weight=None):
    """Top-S support of an (already sparse) [b;c]: returns sel_idx,
    sel_valid.  Valid = nonzero entry (reference idx = b .!= 0)."""
    mag = joint_magnitude(b, c, zkeep, weight)
    _, topi = torch.topk(mag, S, dim=1)
    vals = torch.gather(torch.cat([b, c], dim=1), 1, topi)
    return topi, vals != 0


def put_slots(arr, idx, valid, vals):
    """``arr`` (B, p) with entry ``idx[t, s]`` of each valid slot replaced
    by ``vals[t, s]`` (idx, valid, vals (B, S)); an invalid slot writes
    nothing, though its index may be a valid slot's too."""
    hit = torch.zeros_like(arr, dtype=torch.int32).scatter_add_(
        1, idx, valid.to(torch.int32)) > 0
    new = torch.zeros_like(arr).scatter_add_(
        1, idx, torch.where(valid, vals, torch.zeros_like(vals)))
    return torch.where(hit, new, arr)


def project_k(x, k: int, weight=None):
    """Single-vector top-k hard threshold (reference src/utilities.jl:553-559):
    keeps exactly min(k, nnz) entries of ``x`` (p,) by (weighted) magnitude,
    the lower index first on ties; returns a new tensor."""
    x = torch.as_tensor(x)
    mag = x.abs() if weight is None else x.abs() * torch.as_tensor(
        weight, dtype=x.dtype, device=x.device)
    topi = torch.sort(-mag, stable=True).indices[:k]
    out = torch.zeros_like(x)
    out[topi] = x[topi]
    return out


def _group_sparse(y, group0, ks, J: int, n_groups: int):
    """Doubly-sparse projection of each row of y (B, p): group0 (p,) int64
    in [0, n_groups), or (B, p) with each row's own groups (a sharded
    projection's candidates), ks (B, n_groups) int64 the per-group caps of
    each row.  A row keeps an entry that ranks below its group's cap within
    the group (by magnitude, stably) in one of the J groups with the
    largest l2 norm of those entries (stably); every other entry is
    zeroed."""
    B, p = y.shape
    dev = y.device
    pos = torch.arange(p, device=dev).expand(B, p)
    order = torch.sort(-y.abs(), dim=1, stable=True).indices   # magnitude desc
    rows = group0.dim() == 2
    g_sorted = torch.gather(group0, 1, order) if rows else group0[order]
    # occurrence index of each entry within its group, in magnitude order
    ord2 = torch.sort(g_sorted, dim=1, stable=True).indices
    g2 = torch.gather(g_sorted, 1, ord2)
    is_start = torch.ones_like(g2, dtype=torch.bool)
    is_start[:, 1:] = g2[:, 1:] != g2[:, :-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    occ_sorted = torch.zeros_like(pos).scatter_(1, ord2, pos - seg_start)
    rank_in_group = torch.zeros_like(pos).scatter_(1, order, occ_sorted)
    in_topk = rank_in_group < torch.gather(ks, 1, group0.expand(B, p))
    # group norms from the top-k contributions
    contrib = torch.where(in_topk, y * y, torch.zeros_like(y))
    gnorm = torch.zeros((B, n_groups), dtype=y.dtype, device=dev)
    gnorm = (gnorm.scatter_add_(1, group0, contrib) if rows
             else gnorm.index_add_(1, group0, contrib))
    grank_order = torch.sort(-gnorm, dim=1, stable=True).indices
    grank = torch.zeros_like(grank_order).scatter_(
        1, grank_order,
        torch.arange(n_groups, device=dev).expand(B, n_groups).contiguous())
    keep_group = torch.gather(grank, 1, group0.expand(B, p)) < J
    return torch.where(in_topk & keep_group, y, torch.zeros_like(y))


def _group0(group, device):
    return (torch.as_tensor(group, device=device) - 1).to(torch.int64)


def project_group_sparse_batched(y, group, J: int, ks, n_groups: int):
    """Batched doubly-sparse projection with one (n_groups,) vector of
    per-group caps ``ks`` for every row of y (B, p); ``group`` (p,) holds
    1-based group ids."""
    ks = torch.as_tensor(ks, device=y.device).to(torch.int64)
    return _group_sparse(y, _group0(group, y.device), ks.expand(
        y.shape[0], n_groups), J, n_groups)


def project_group_sparse_per_task(y, group, J: int, k_task, n_groups: int):
    """Batched doubly-sparse projection where every group's cap is the
    task's own scalar sparsity ``k_task`` (B,): the reference's ``v.k`` for
    scalar-k group IHT, which cross-validation varies per (fold, k) combo
    (reference src/cross_validation.jl:109, src/utilities.jl:255)."""
    k_task = torch.as_tensor(k_task, device=y.device).to(torch.int64)
    return _group_sparse(y, _group0(group, y.device),
                         k_task.reshape(-1, 1).expand(y.shape[0], n_groups),
                         J, n_groups)


def project_group_sparse(y, group, J: int, k):
    """Project onto at most J active groups with at most k (or k[g])
    predictors each.  y (p,) or (B, p); group (p,) 1-based group ids (the
    reference's convention); k a scalar or a per-group vector."""
    y = torch.as_tensor(y)
    n_groups = int(np.max(np.asarray(group)))
    if np.ndim(k) == 0:
        ks = torch.full((n_groups,), int(k), dtype=torch.int64)
    else:
        ks = torch.as_tensor(np.asarray(k), dtype=torch.int64)
    out = project_group_sparse_batched(y.reshape(-1, y.shape[-1]), group, J,
                                       ks, n_groups)
    return out.reshape(y.shape)
