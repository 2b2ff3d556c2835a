"""The genotype operator split over the SNP axis of a (task, snp) mesh (the
JAX package's ``parallel/sharded_ops.py``, whose products run under
``shard_map``; here each rank runs its own block and the collectives are
explicit):

  * ``xtr`` (score X'R): a rank owns its SNP rows, so no communication; on
    the card kernel 1 (``kernels.xt_dots_words``) on the rank's quad rows
    (the reference's thread-local column loops, src/utilities.jl:96-106);
  * ``forward_sel`` (k-sparse X[:, idx] @ coef), ``gather_cols``: each rank
    takes the selected columns it owns, then one sum over the task row's
    ranks (the reference's ``sum!`` over per-thread accumulators);
  * the gathers from and projections of the (B, p) arrays exchange (B, S)
    candidate lists, never a (B, p) array: per-rank top-S candidates, an
    all-gather of them, the global top-S (SURVEY.md §5);
  * the reductions over the SNP axis (the convergence maxima, debias's
    support test, the warm start's intercept) combine the ranks' partial
    ones.

The solver (``models/univariate.py``, ``models/mv.py``) reaches all of this
through its operator dispatchers, and splits the task batch over the task
rows of the mesh (``task_rows`` / ``gather_tasks``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..genotype.snparray import PackedGenotypes
from ..ops.linalg import PackedOp
from ..ops.projections import _group_sparse, put_slots
from .mesh import Mesh


@dataclasses.dataclass
class ShardedPackedOp:
    """A PackedOp over this rank's SNP shard, whose products and support
    primitives give what the single-device PackedOp over all the shards
    gives.

    ``geno`` is this rank's block of the genotypes: p_local SNP rows, whole
    quad words (``mesh.shard_geno_op`` cuts it out of whole genotypes,
    ``multihost.load_bed_shard`` reads it from a ``.bed``); every rank of
    the mesh holds as many, and their ``has_missing`` agree.  ``p`` is the
    global (padded) SNP count and the indices the solver passes are global;
    its (B, p) arrays hold the rank's columns (``p_local``) and its task
    rows.  ``dtype`` as PackedOp's."""
    geno: PackedGenotypes
    mesh: Mesh
    dtype: torch.dtype | None = None

    def __post_init__(self):
        g = self.geno
        if g.p != 4 * g.words.shape[0]:
            raise ValueError(f"a shard holds whole quad rows: p={g.p} of "
                             f"{g.words.shape[0]} quad rows")
        # the score-only dual layout is single-device: kernel 1 on the
        # rank's quad rows
        self.local = PackedOp(dataclasses.replace(g, words_t=None),
                              self.dtype)
        self.dtype = self.local.dtype
        self.p_local = g.p
        self.offset = self.mesh.coords["snp"] * g.p

    @property
    def n(self):
        return self.geno.n

    @property
    def p(self):
        return self.p_local * self.mesh.shape["snp"]

    @property
    def n_pad(self):
        return self.geno.n_pad

    @property
    def device(self):
        return self.geno.device

    def _owned(self, gidx):
        """(local index, 0 where not owned; owned) of global SNP indices."""
        lidx = gidx - self.offset
        owned = (lidx >= 0) & (lidx < self.p_local)
        return torch.where(owned, lidx, torch.zeros_like(lidx)), owned

    def _sum(self, x):
        return self.mesh.all_reduce(x, "snp", "sum")

    def _gather(self, x, dim=1):
        return self.mesh.all_gather(x, "snp", dim)

    # -- products ---------------------------------------------------------
    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """Standardized X' R for R (B, n_pad) -> (B, p_local): this rank's
        columns, no communication."""
        return self.local.xtr(R)

    def xtr_multi(self, GR: torch.Tensor) -> torch.Tensor:
        """(T, r, n_pad) -> (T, r, p_local): the mv score with the traits on
        the RHS batch."""
        T, r, n_pad = GR.shape
        return self.local.xtr(GR.reshape(T * r, n_pad)).reshape(T, r, -1)

    def forward_sel(self, idx, coef, valid):
        lidx, owned = self._owned(idx)
        return self._sum(self.local.forward_sel(lidx, coef,
                                                valid * owned.to(valid.dtype)))

    def forward_sel_multi(self, idx, coef, valid):
        lidx, owned = self._owned(idx)
        return self._sum(self.local.forward_sel_multi(
            lidx, coef, valid * owned.to(valid.dtype)))

    def gather_cols(self, idx, valid):
        lidx, owned = self._owned(idx)
        return self._sum(self.local.gather_cols(lidx,
                                                valid * owned.to(valid.dtype)))

    def col_moments(self, W, WY):
        """Sx, Sxx, Sxy of this rank's columns, each (B, p_local)."""
        return self.local.col_moments(W, WY)

    # -- the solver's hooks: the task axis and the SNP-axis reductions -----
    def task_rows(self, x):
        """This rank's task rows of a (B, ...) array of every task."""
        return self.mesh.block(x, "task", 0).contiguous()

    def gather_tasks(self, x):
        """Every task's rows of a (B_local, ...) array."""
        return self.mesh.all_gather(x, "task", 0)

    def gather_snps(self, x):
        """A (..., p) array whole from this rank's (..., p_local) columns."""
        return self._gather(x, x.dim() - 1)

    def reduce_snp(self, x, how: str):
        """A reduction over the SNP axis ("sum" or "max") of this rank's
        columns, over all of them."""
        return self.mesh.all_reduce(x, "snp", how)

    # -- support primitives: exchange (B, S) lists, never (B, p) ------------
    def take_b(self, arr, gidx, gval):
        """Masked (B, S) gather from the (B, p_local) block: each rank
        contributes the entries it owns; one small sum."""
        lidx, owned = self._owned(gidx)
        v = torch.gather(arr, 1, lidx)
        return self._sum(torch.where(gval & owned, v, torch.zeros_like(v)))

    def take_b_multi(self, arr, gidx, gval):
        """Masked (T, r, S) gather from the (T, r, p_local) block."""
        lidx, owned = self._owned(gidx)
        T, r, _ = arr.shape
        v = torch.gather(arr, 2, lidx[:, None, :].expand(T, r,
                                                         lidx.shape[1]))
        return self._sum(v * (gval & owned)[:, None, :])

    def put_b(self, arr, gidx, gval, vals):
        """The (B, p_local) block with the owned valid slots' entries
        replaced by vals (B, S)."""
        lidx, owned = self._owned(gidx)
        return put_slots(arr, lidx, gval & owned, vals)

    def _candidates(self, b, c, zkeep, S, weight):
        """Two-stage top-S over the sharded joint [b; c]: each rank's top
        min(S, p_local) of |b| (weighted), an all-gather of their values
        and global indices, the global top-S of those and the whole c.
        Returns (sel_idx (B, S) global [b; c] indices, their values)."""
        p, off = self.p, self.offset
        B, p_local = b.shape
        q = c.shape[1]
        magb = b.abs()
        if weight is not None:
            magb = magb * weight[off:off + p_local][None, :]
        _, i = torch.topk(magb, min(S, p_local), dim=1)
        cand_x = self._gather(torch.gather(b, 1, i))
        cand_i = self._gather(i + off)
        cand_v = cand_x.abs()
        magc = c.abs()
        if weight is not None:
            cand_v = cand_v * weight[cand_i]
            magc = magc * weight[p:][None, :]
        magc = torch.where(zkeep[None, :], torch.full_like(magc,
                                                           float("inf")), magc)
        cat_i = torch.cat([cand_i, (p + torch.arange(
            q, device=b.device))[None, :].expand(B, q)], dim=1)
        _, sel = torch.topk(torch.cat([cand_v, magc], dim=1), S, dim=1)
        return (torch.gather(cat_i, 1, sel),
                torch.gather(torch.cat([cand_x, c], dim=1), 1, sel))

    def select_support(self, b, c, zkeep, S):
        sel_idx, vals = self._candidates(b, c, zkeep, S, None)
        return sel_idx, vals != 0

    def project_topk_joint(self, b, c, k_plus_keep, zkeep, S, weight=None):
        """The joint top-k projection (``ops.projections.
        project_topk_joint``) over the sharded [b; c]: each task keeps its
        k_plus_keep largest entries, the zkeep covariates their values."""
        p = self.p
        sel_idx, vals = self._candidates(b, c, zkeep, S, weight)
        keep = (torch.arange(S, device=b.device)[None, :]
                < k_plus_keep[:, None])
        kept = torch.where(keep, vals, torch.zeros_like(vals))
        lsel, owned = self._owned(sel_idx)
        b_new = torch.zeros_like(b).scatter_add_(
            1, lsel, torch.where(owned, kept, torch.zeros_like(kept)))
        is_c = sel_idx >= p
        c_new = torch.zeros_like(c).scatter_add_(
            1, torch.where(is_c, sel_idx - p, torch.zeros_like(sel_idx)),
            torch.where(is_c, kept, torch.zeros_like(kept)))
        c_new = torch.where(zkeep[None, :], c, c_new)
        return b_new, c_new, sel_idx, vals, keep & (vals != 0)

    def project_group_sparse(self, b1, group, J: int, ks, k_task,
                             n_groups: int, cand: int):
        """The doubly-sparse projection (reference project_group_sparse!,
        src/utilities.jl:613-679) over the sharded b: each rank's
        group-local top-k (no group choice), its top ``cand`` survivors
        (``cfg.group_cand``, at most p_local) exchanged with their groups,
        the global projection over those candidates, the owned ones
        written back.  Exact: a global survivor survives its rank's
        per-group top-k, and ``cand`` bounds a rank's survivors, so the
        candidates hold the global support.  ``ks`` (n_groups,) caps the
        groups where ``k_task`` is None, else each task's own k (B,)."""
        B, p_local = b1.shape
        off = self.offset
        group0 = (group.to(torch.int64) - 1)[off:off + p_local]
        if k_task is None:
            ks_rows = ks.to(torch.int64).expand(B, n_groups)
        else:
            ks_rows = k_task.to(torch.int64).reshape(-1, 1).expand(
                B, n_groups)
        v_loc = _group_sparse(b1, group0, ks_rows, n_groups, n_groups)
        _, lidx = torch.topk(v_loc.abs(), min(max(cand, 1), p_local), dim=1)
        cat_x = self._gather(torch.gather(v_loc, 1, lidx))
        cat_i = self._gather(lidx + off)
        cat_g = self._gather(group0[lidx])
        kept = _group_sparse(cat_x, cat_g, ks_rows, J, n_groups)
        lsel, owned = self._owned(cat_i)
        return torch.zeros_like(b1).scatter_add_(
            1, lsel, torch.where(owned, kept, torch.zeros_like(kept)))

    # -- multivariate (reference src/multivariate.jl:66-127) ----------------
    def project_joint_mv(self, Bm, Cm, k_plus_keep, zkeep, S_entries: int):
        """The mv entry-level projection (``models/mv._project_joint_mv``)
        over the trait-major [vec(B); vec(C)]: each rank's top-S entries of
        its (r, p_local) block, one (T, n_snp*S + r*q) candidate exchange,
        never a gather of the (T, r, p) tensor."""
        p, off = self.p, self.offset
        T, r, p_local = Bm.shape
        q = Cm.shape[2]
        flatB = Bm.reshape(T, r * p_local)
        _, i = torch.topk(flatB.abs(), min(S_entries, r * p_local), dim=1)
        # local flat (trait j, column l) -> global flat j * p + off + l
        cand_x = self._gather(torch.gather(flatB, 1, i))
        cand_i = self._gather((i // p_local) * p + off + i % p_local)
        flatC = Cm.reshape(T, r * q)
        pin_c = zkeep.repeat(r)
        magc = torch.where(pin_c[None, :],
                           torch.full_like(flatC, float("inf")), flatC.abs())
        cat_i = torch.cat([cand_i, (r * p + torch.arange(
            r * q, device=Bm.device))[None, :].expand(T, r * q)], dim=1)
        _, sel = torch.topk(torch.cat([cand_x.abs(), magc], dim=1),
                            S_entries, dim=1)
        sel_idx = torch.gather(cat_i, 1, sel)
        vals = torch.gather(torch.cat([cand_x, flatC], dim=1), 1, sel)
        keep = (torch.arange(S_entries, device=Bm.device)[None, :]
                < k_plus_keep[:, None])
        kept = torch.where(keep, vals, torch.zeros_like(vals))
        is_b = sel_idx < r * p
        lcol, owned = self._owned(sel_idx % p)
        owned = owned & is_b
        lflat = torch.where(owned, (sel_idx // p) * p_local + lcol,
                            torch.zeros_like(sel_idx))
        B_new = torch.zeros_like(flatB).scatter_add_(
            1, lflat, torch.where(owned, kept, torch.zeros_like(kept)))
        C_new = torch.zeros_like(flatC).scatter_add_(
            1, torch.where(is_b, torch.zeros_like(sel_idx), sel_idx - r * p),
            torch.where(is_b, torch.zeros_like(kept), kept))
        C_new = torch.where(pin_c[None, :], flatC, C_new)
        return B_new.reshape(T, r, p_local), C_new.reshape(T, r, q)

    def column_support_mv(self, Bm, S: int):
        """The mv column support (``models/mv._column_support``): the top-S
        SNP columns by max |B| over the traits, by a per-rank top-S
        candidate exchange."""
        colmag = Bm.abs().amax(dim=1)                      # (T, p_local)
        v, i = torch.topk(colmag, min(S, colmag.shape[1]), dim=1)
        cand_v = self._gather(v)
        cand_i = self._gather(i + self.offset)
        vals, sel = torch.topk(cand_v, S, dim=1)
        return torch.gather(cand_i, 1, sel), vals != 0
