"""The (task, snp) grid of ranks, its collectives, and sharding specs (the
JAX package's ``parallel/mesh.py`` on ``torch.distributed``, one process a
device).

  * ``task`` axis: data parallelism over the cross-validation (fold, k)
    tasks (the reference's ``Threads.@threads :static`` pool,
    src/cross_validation.jl:100); the ranks of one SNP column of the grid
    hold different task rows and meet only to gather the results.
  * ``snp`` axis: model parallelism over the SNPs (the reference's
    thread-sharded column loops, src/utilities.jl:96-106).  The packed
    genotypes and the (B, p) arrays b / b0 / best_b / df split along p; the
    score X'R needs no communication; the k-sparse forward product, the
    gathers and the top-k projection exchange partial sums or (B, S)
    candidate lists within one task row of the grid
    (``parallel/sharded_ops.py``).

Per-sample arrays (y, mu, xb, cv_wts) are whole on every rank of a task row
and split over the task rows.  Where the JAX package places one global array
with a sharding, each rank here holds its own block: ``shard_state`` cuts a
rank's block out of a whole state, ``gather_state`` joins the blocks back
into the whole state on every rank.

Every collective goes through :meth:`Mesh.all_reduce` /
:meth:`Mesh.all_gather`.  Where the world's backend is gloo and the mesh's
device is a card (two ranks on one card: NCCL refuses two ranks on one
GPU), they copy their operands to the host and the result back, since gloo
has no CUDA ``all_gather``; the mesh decides that once, from the backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..genotype.snparray import PackedGenotypes

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in an (n_task, n_snp) grid of the world's ranks
    (rank r at task row r // n_snp, SNP column r % n_snp, as the JAX
    package reshapes its device list), with a process group along each
    axis: ``groups["snp"]`` the ranks of this rank's task row (they share
    its tasks and split the SNPs), ``groups["task"]`` those of its SNP
    column (they share its SNPs and split the tasks)."""
    shape: dict              # {"task": n_task, "snp": n_snp}
    coords: dict             # this rank's {"task": t, "snp": s}
    groups: dict             # {"task": ProcessGroup, "snp": ProcessGroup}
    device: torch.device     # the device of this rank's blocks
    host_staged: bool        # collectives copy card operands to the host
    # collectives run through this mesh, by kind
    calls: dict = dataclasses.field(default_factory=lambda: {
        "all_reduce": 0, "all_gather": 0})

    axis_names = ("task", "snp")

    @property
    def ranks(self) -> np.ndarray:
        """(n_task, n_snp) world ranks of the grid (the JAX mesh's
        ``devices``)."""
        return np.arange(self.shape["task"] * self.shape["snp"]).reshape(
            self.shape["task"], self.shape["snp"])

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh copy of x where the collective runs: the host for a card
        tensor under gloo, else x's device (collectives work in place)."""
        if self.host_staged and x.device.type == "cuda":
            return x.detach().to("cpu", copy=True).contiguous()
        return x.detach().clone().contiguous()

    def all_reduce(self, x: torch.Tensor, axis: str = "snp",
                   op: str = "sum") -> torch.Tensor:
        """x reduced over the ranks along ``axis`` ("sum" or "max"); every
        rank gets the same result."""
        y = self._staged(x)
        dist.all_reduce(y, op=_OPS[op], group=self.groups[axis])
        self.calls["all_reduce"] += 1
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: str = "snp",
                   dim: int = 0) -> torch.Tensor:
        """The ranks' x along ``axis`` joined on ``dim`` in rank order."""
        y = self._staged(x)
        parts = [torch.empty_like(y) for _ in range(self.shape[axis])]
        dist.all_gather(parts, y, group=self.groups[axis])
        self.calls["all_gather"] += 1
        return torch.cat(parts, dim=dim).to(x.device)

    def block(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's block of x along ``dim``, split evenly over the
        ranks of ``axis`` (the JAX package requires even splits too)."""
        n, size = self.shape[axis], x.shape[dim]
        if size % n:
            raise ValueError(f"{size} rows do not split evenly over the "
                             f"{n} ranks of the {axis!r} axis")
        per = size // n
        return x.narrow(dim, self.coords[axis] * per, per)


def rank_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the card of this rank (rank
    modulo the cards), raising where there is none: a caller who wants the
    CPU passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def make_mesh(n_task: int | None = None, n_snp: int | None = None,
              device=None) -> Mesh:
    """The (task, snp) mesh over the world of an initialized process group
    (``multihost.init_process_group``): with neither size given every rank
    is a task row (n_snp = 1), as in the JAX package.  Every rank calls it,
    in the same order (it creates process groups).  ``device`` is this
    rank's (default :func:`rank_device`)."""
    world = dist.get_world_size()
    if n_task is None and n_snp is None:
        n_task, n_snp = world, 1
    elif n_task is None:
        n_task = world // n_snp
    elif n_snp is None:
        n_snp = world // n_task
    if n_task * n_snp != world:
        raise ValueError(f"mesh {n_task}x{n_snp} does not fill the world of "
                         f"{world} ranks")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(n_task, n_snp)
    groups = {}
    # every rank creates every group, rows then columns
    for t in range(n_task):
        g = dist.new_group(grid[t].tolist())
        if t == rank // n_snp:
            groups["snp"] = g
    for s in range(n_snp):
        g = dist.new_group(grid[:, s].tolist())
        if s == rank % n_snp:
            groups["task"] = g
    device = rank_device(device)
    return Mesh(shape={"task": n_task, "snp": n_snp},
                coords={"task": rank // n_snp, "snp": rank % n_snp},
                groups=groups, device=device,
                host_staged=(dist.get_backend() == "gloo"
                             and device.type == "cuda"))


def pad_geno_rows(geno: PackedGenotypes, n_shards: int) -> PackedGenotypes:
    """Genotypes padded to an even multiple of ``n_shards`` SNP rows, each
    shard whole quad-word rows, so they shard over the 'snp' axis when p
    is ragged.  Pad rows are inert: words zero, inv_sd == 0 (every
    standardized product gets exactly 0 from them), mu == 0.  Callers keep
    the true p for betas: the projections never select a pad row, whose
    score is identically zero.  ``multihost.load_bed_shard`` pads the same
    way."""
    p = geno.p
    per = -(-(-(-p // n_shards)) // 4) * 4
    p_pad = per * n_shards
    if p_pad == p:
        return geno
    words, mu, inv = geno.words, geno.mu, geno.inv_sd
    extra_q = p_pad // 4 - words.shape[0]
    if extra_q > 0:
        words = torch.cat([words, words.new_zeros((extra_q,
                                                   words.shape[1]))])
    return dataclasses.replace(
        geno, words=words, mu=torch.cat([mu, mu.new_zeros(p_pad - p)]),
        inv_sd=torch.cat([inv, inv.new_zeros(p_pad - p)]), p=p_pad,
        maf_=None, n_missing=None, words_t=None)


def geno_sharding(mesh: Mesh) -> dict:
    """PackedGenotypes' specs: the packed rows (SNPs) and their stats over
    'snp'.  A spec names the mesh axis each dimension splits over (None:
    whole), as the JAX package's ``PartitionSpec``."""
    return dict(words=("snp", None), mu=("snp",), inv_sd=("snp",))


def state_sharding(mesh: Mesh) -> dict:
    """IHTState specs: (B, p) arrays over (task, snp); (B, n) and (B,)
    arrays over task; the host iteration whole."""
    bp, bn, b_ = ("task", "snp"), ("task", None), ("task",)
    return dict(
        b=bp, b0=bp, best_b=bp, df=bp,
        c=bn, c0=bn, best_c=bn, df2=bn,
        sel_idx=bn, sel_valid=bn, idc=bn,
        xb=bn, zc=bn, mu=bn, cv_wts=bn,
        nb_r=b_, logl=b_, best_logl=b_, k=b_, active=b_, failed=b_,
        iters=b_, eta=b_, backtracks=b_,
        iteration=(),
    )


def mv_state_sharding(mesh: Mesh) -> dict:
    """MIHTState specs: (T, r, p) tensors over (task, -, snp); (T, r, n)
    and (T, r, q) over task; per-task values over task."""
    trp, trx = ("task", None, "snp"), ("task", None, None)
    tn, t_ = ("task", None), ("task",)
    return dict(
        B=trp, B0=trp, best_B=trp, df=trp,
        C=trx, C0=trx, best_C=trx, df2=trx,
        Gamma=trx, Gamma0=trx,
        BX=trx, CZ=trx, mu=trx, resid=trx,
        sel_idx=tn, sel_valid=tn, idc=tn, cv_wts=tn,
        logl=t_, best_logl=t_, k=t_, active=t_, failed=t_,
        iters=t_, eta=t_, backtracks=t_,
        iteration=(),
    )


def _blocks(st, mesh: Mesh, specs: dict):
    """st with every spec'd field cut to this rank's block, on its
    device."""
    updates = {}
    for f in dataclasses.fields(st):
        v, spec = getattr(st, f.name), specs.get(f.name, ())
        if not isinstance(v, torch.Tensor):
            continue
        for dim, axis in enumerate(spec):
            if axis is not None:
                v = mesh.block(v, axis, dim)
        updates[f.name] = v.to(mesh.device).contiguous()
    return dataclasses.replace(st, **updates)


def shard_state(st, mesh: Mesh):
    """This rank's block of a whole IHTState (the JAX package places the
    whole state with its shardings)."""
    return _blocks(st, mesh, state_sharding(mesh))


def shard_mv_state(st, mesh: Mesh):
    """This rank's block of a whole MIHTState."""
    return _blocks(st, mesh, mv_state_sharding(mesh))


def gather_state(st, mesh: Mesh):
    """The whole state (IHTState or MIHTState) on every rank from the
    ranks' blocks: the port's ``np.asarray`` of a sharded global array.
    Every rank calls it."""
    specs = (state_sharding(mesh) if hasattr(st, "best_b")
             else mv_state_sharding(mesh))
    updates = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        for dim, axis in enumerate(specs.get(f.name, ())):
            if axis is not None:
                v = mesh.all_gather(v, axis, dim)
        updates[f.name] = v
    return dataclasses.replace(st, **updates)


def shard_data(data, mesh: Mesh):
    """FitData is whole on every rank (y, z and the masks are small
    per-sample arrays; weight and group stay whole too, and the sharded
    operator reads its own SNPs of them): moved to the mesh's device."""
    from .multihost import replicate
    return replicate(data, mesh)


def shard_mv_data(data, mesh: Mesh):
    """MvData is whole on every rank: moved to the mesh's device."""
    from .multihost import replicate
    return replicate(data, mesh)


def shard_geno_op(op, mesh: Mesh):
    """The sharded operator of a whole PackedOp: this rank's SNP rows of
    its genotypes (p an even multiple of 4 x n_snp; :func:`pad_geno_rows`
    pads them) on the mesh's device, without the transposed dual layout
    (the score-only layout is single-device: each shard's score runs kernel
    1 on its own quad rows, as in the JAX package).  Any other operator is
    returned as it is."""
    from ..ops.linalg import PackedOp
    from .sharded_ops import ShardedPackedOp
    if not isinstance(op, PackedOp):
        return op
    g, ns = op.geno, mesh.shape["snp"]
    if g.p % (4 * ns):
        raise ValueError(f"p={g.p} does not split into whole quad rows over "
                         f"{ns} SNP shards: pad_geno_rows(geno, {ns}) first")
    per, s = g.p // ns, mesh.coords["snp"]
    dev = mesh.device
    local = PackedGenotypes(
        words=g.words[s * per // 4:(s + 1) * per // 4].to(dev).contiguous(),
        mu=g.mu[s * per:(s + 1) * per].to(dev),
        inv_sd=g.inv_sd[s * per:(s + 1) * per].to(dev),
        n=g.n, p=per, has_missing=g.has_missing)
    return ShardedPackedOp(local, mesh, op.dtype)
