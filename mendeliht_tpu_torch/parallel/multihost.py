"""Multi-process execution on ``torch.distributed`` (the JAX package's
``parallel/multihost.py``).

The reference scales cross-validation with Distributed.jl ``addprocs``:
every worker holds a whole copy of the genotypes and fits its share of the
(fold, k) tasks (reference src/cross_validation.jl:133-204).  Here, as in
the JAX package, one program runs on every rank of a (task, snp) mesh, one
process a device:

  * each rank reads only its own SNP shard of the ``.bed`` (the format is
    SNP-major, so a shard is one contiguous byte range: no rank touches the
    whole matrix) and repacks it on its device;
  * the solver runs unchanged: ``fit_iht``, ``cv_iht`` and the mv fit and
    cv take the :class:`~.sharded_ops.ShardedPackedOp`, and its collectives
    run within the mesh's task rows;
  * per-sample arrays are whole on every rank; the cv (fold, k) tasks split
    over the task rows.

Usage (the same script started once a rank):

    from mendeliht_tpu_torch.parallel import multihost as mh
    mh.init_process_group("tcp://host:port", world_size=2, rank=r)
    mesh = mh.make_global_mesh(n_snp=2)
    geno, p_true = mh.load_bed_shard("data/geno", mesh)
    result = fit_iht(y, ShardedPackedOp(geno, mesh), k=10)
    beta = result.beta[:p_true]
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..genotype.snparray import PackedGenotypes, _ceil_to, _LANE
from ..utils.device import float_dtype
from .mesh import Mesh, make_mesh


def init_process_group(init_method: str | None = None,
                       world_size: int | None = None,
                       rank: int | None = None, backend: str | None = None,
                       timeout: float | None = None):
    """Join the process group (no-op if this process is in one already).

    With no arguments the environment says where and who
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``); pass
    them for a local cluster, e.g. ``init_method="tcp://localhost:29500"``
    or ``"file:///path/to/shared/file"``.  ``backend`` defaults to NCCL
    where there is a card, else gloo; two ranks on one card take gloo
    (NCCL refuses them).  ``timeout`` (s) bounds every collective, so a
    rank that stops answering fails the others rather than hanging them.
    The JAX package's ``initialize`` (reference analog: ``addprocs`` +
    ``@everywhere using MendelIHT``)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)


def make_global_mesh(n_task: int | None = None, n_snp: int | None = None,
                     device=None) -> Mesh:
    """The (task, snp) mesh over every rank of the world."""
    return make_mesh(n_task=n_task, n_snp=n_snp, device=device)


def shard_rows(p: int, n_shards: int):
    """(p_pad, per-shard row ranges): equal shards, rounded to multiples of
    4 so every shard owns whole quad-word rows (``genotype/snparray.py``
    layout).  Pad rows carry inv_sd == 0, so they are inert in every
    product; callers cut them off by the true p."""
    per = -(-(-(-p // n_shards)) // 4) * 4
    return per * n_shards, [(min(i * per, p), min((i + 1) * per, p))
                            for i in range(n_shards)]


def bed_dims(prefix: str) -> tuple[int, int]:
    """(n, p) from the ``.fam`` line count and the ``.bed`` byte size."""
    with open(prefix + ".fam") as f:
        n = sum(1 for line in f if line.strip())
    bpr = -(-n // 4)
    size = os.path.getsize(prefix + ".bed") - 3
    if size % bpr:
        raise ValueError(f"{prefix}.bed size is not a multiple of ceil(n/4)")
    return n, size // bpr


def load_bed_shard(prefix: str, mesh: Mesh, dtype=torch.float32
                   ) -> tuple[PackedGenotypes, int]:
    """This rank's SNP shard of a PLINK ``.bed``.

    The rank reads only the contiguous byte range of its SNP rows (SNP j
    occupies bytes [3 + j*ceil(n/4), 3 + (j+1)*ceil(n/4))) and repacks it
    on the mesh's device (``PackedGenotypes.from_bed_bytes``), padded to
    the shard size of :func:`shard_rows` with inert rows (zero words,
    inv_sd == 0).  ``has_missing`` must agree on every rank, so the ranks'
    missing-call counts are summed first.  Every rank calls it.

    Returns (genotypes of this rank's shard, p_true): the sharded operator
    is ``ShardedPackedOp(geno, mesh)``, its p the padded one; slice betas
    to p_true."""
    dtype = float_dtype(dtype, "load_bed_shard")
    n, p = bed_dims(prefix)
    bpr = -(-n // 4)
    p_pad, ranges = shard_rows(p, mesh.shape["snp"])
    per = p_pad // mesh.shape["snp"]
    lo, hi = ranges[mesh.coords["snp"]]
    dev = mesh.device
    words = torch.zeros((per // 4, _ceil_to(bpr, _LANE)), dtype=torch.int32,
                        device=dev)
    mu = torch.zeros(per, dtype=dtype, device=dev)
    inv_sd = torch.zeros(per, dtype=dtype, device=dev)
    missing = 0
    if hi > lo:
        with open(prefix + ".bed", "rb") as f:
            f.seek(3 + lo * bpr)
            raw = np.frombuffer(f.read((hi - lo) * bpr), np.uint8)
        sub = PackedGenotypes.from_bed_bytes(raw, n, hi - lo, dtype,
                                             device=dev)
        words[:sub.words.shape[0]] = sub.words
        mu[:hi - lo] = sub.mu
        inv_sd[:hi - lo] = sub.inv_sd
        missing = int(sub.n_missing.sum())
    total = mesh.all_reduce(torch.tensor([missing], dtype=torch.int64,
                                         device=dev), "snp")
    geno = PackedGenotypes(words=words, mu=mu, inv_sd=inv_sd, n=n, p=per,
                           has_missing=bool(total.item() > 0))
    return geno, p


def replicate(tree, mesh: Mesh):
    """Every tensor and numpy array in ``tree`` (a tensor, an array, a
    dataclass, dict, list or tuple of them) as a tensor on the mesh's
    device: the whole copy each rank holds of per-sample data."""
    if isinstance(tree, torch.Tensor):
        return tree.to(mesh.device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=mesh.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(getattr(tree, f.name), mesh)
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def nnz_throughput(n: int, p: int, iters: int, seconds: float) -> float:
    """Scaling metric: genotype entries streamed per second."""
    return n * p * max(iters, 1) / seconds


def scaling_efficiency(single_host_nnz_s: float, multi_host_nnz_s: float,
                       n_hosts: int) -> float:
    return multi_host_nnz_s / (single_host_nnz_s * n_hosts)


def comm_model(n: int, p: int, B: int = 1, n_task: int = 1, n_snp: int = 1,
               stream_bytes_per_s: float = 750e9,
               link_bytes_per_s: float = 45e9,
               backtracks_per_iter: float = 0.0) -> dict:
    """Per-iteration byte and time model of the SNP-sharded solver (the
    JAX package's arithmetic and defaults: ``stream_bytes_per_s`` and
    ``link_bytes_per_s`` are its TPU v5e assumptions, so pass a card's own
    rates to model one).

      * local: one full read of the shard's packed words an iteration (the
        score needs no communication);
      * collectives: the forward product and the stepsize product each sum
        a (B/n_task, n_pad) f32 over the task row (a ring all-reduce moves
        2*(ns-1)/ns of the payload a rank), each backtrack one more; the
        top-k exchanges only candidate lists (negligible).

    The predicted efficiency assumes no overlap of compute and
    communication."""
    n4 = _ceil_to(-(-n // 4), _LANE)
    n_pad = 4 * n4
    local_bytes = (p / max(n_snp, 1)) * n4
    psums = 2.0 + backtracks_per_iter
    payload = psums * (B / max(n_task, 1)) * n_pad * 4
    ring = 2.0 * (n_snp - 1) / n_snp if n_snp > 1 else 0.0
    comm_bytes = payload * ring
    t_local = local_bytes / stream_bytes_per_s
    t_comm = comm_bytes / link_bytes_per_s
    t1 = p * n4 / stream_bytes_per_s
    return {
        "local_bytes_per_iter": local_bytes,
        "psum_payload_bytes_per_iter": payload,
        "collective_bytes_per_iter": comm_bytes,
        "t_local_s": t_local,
        "t_comm_s": t_comm,
        "t_iter_s": t_local + t_comm,
        "predicted_efficiency": t1 / (max(n_snp, 1) * (t_local + t_comm)),
    }
