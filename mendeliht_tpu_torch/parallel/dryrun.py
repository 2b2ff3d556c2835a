"""One sharded solver step on a (task, snp) mesh, univariate and
multivariate: the twin of the JAX package's ``__graft_entry__.py::
dryrun_multichip``, run by every rank of an initialized process group."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..genotype.snparray import PackedGenotypes
from .mesh import (make_mesh, shard_data, shard_geno_op, shard_mv_data,
                   shard_mv_state, shard_state)


def _tiny_problem(device, n=96, p=512, B=4, k=6, seed=0):
    """The JAX package's small batched problem (its ``_tiny_problem``):
    simulated packed genotypes, a Gaussian response, B tasks at k."""
    from ..models.fit import build_fit
    from ..models.initialize import init_state

    rng = np.random.default_rng(seed)
    codes = rng.choice([0, 2, 3], size=(n, p),
                       p=[0.35, 0.4, 0.25]).astype(np.uint8)
    x = PackedGenotypes.from_codes(codes, device=device)
    Xd = x.to_dense_standardized()
    btrue = np.zeros(p)
    btrue[rng.choice(p, k, replace=False)] = rng.standard_normal(k)
    y = Xd @ btrue + rng.standard_normal(n)
    op, data, cfg, _ = build_fit(y, x, None, k=k, max_iter=20)
    cv_wts = data.sample_mask[None, :].expand(B, op.n_pad)
    st = init_state(op, data, cfg, [k] * B, cv_wts)
    return op, data, cfg, st


def dryrun_multichip(n_devices: int | None = None, device=None) -> dict:
    """Two sharded IHT iterations of the JAX package's tiny problem on a
    task x snp mesh of the world's ``n_devices`` ranks (task = 2 where
    that count is even), then two multivariate ones (3 traits); each
    loglikelihood finite and not below the one before (1e-3).  ``device``
    is this rank's (default its card).  Returns the whole loglikelihoods
    after each iteration: {"logl": [it1, it2], "mv_logl": [it1, it2]}."""
    from ..models.mv import _iteration_mv, build_mv, init_mv_state
    from ..models.univariate import _iteration

    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices} but the world has {world} "
                         "ranks")
    n_task = 2 if n_devices % 2 == 0 else 1
    n_snp = n_devices // n_task
    B = 2 * n_task
    mesh = make_mesh(n_task=n_task, n_snp=n_snp, device=device)
    dev = mesh.device
    out = {}

    op, data, cfg, st = _tiny_problem(dev, n=96, p=512, B=B)
    op, data, st = (shard_geno_op(op, mesh), shard_data(data, mesh),
                    shard_state(st, mesh))
    logls = []
    for _ in range(2):
        st = _iteration(op, data, cfg, st)
        logls.append(op.gather_tasks(st.logl))
    _check("univariate", logls, st.iteration)
    out["logl"] = [v.cpu().tolist() for v in logls]

    rng = np.random.default_rng(7)
    n, p, r, kmv = 96, 512, 3, 5
    codes = rng.choice([0, 2, 3], size=(n, p),
                       p=[0.35, 0.4, 0.25]).astype(np.uint8)
    x = PackedGenotypes.from_codes(codes, device=dev)
    Xd = x.to_dense_standardized()
    Btrue = np.zeros((r, p))
    for j in rng.choice(p, kmv, replace=False):
        Btrue[rng.integers(0, r), j] = rng.standard_normal()
    Y = Btrue @ Xd.T + 0.1 * rng.standard_normal((r, n))
    mop, mdata, mcfg = build_mv(Y, x, k=kmv, max_iter=20)
    mst = init_mv_state(mop, mdata, mcfg, [kmv] * B,
                        mdata.sample_mask[None, :].expand(B, mop.n_pad))
    mop, mdata, mst = (shard_geno_op(mop, mesh), shard_mv_data(mdata, mesh),
                       shard_mv_state(mst, mesh))
    logls = []
    for _ in range(2):
        mst = _iteration_mv(mop, mdata, mcfg, mst)
        logls.append(mop.gather_tasks(mst.logl))
    _check("mv", logls, mst.iteration)
    out["mv_logl"] = [v.cpu().tolist() for v in logls]
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK on mesh task={n_task} x snp={n_snp}: "
              f"logl {np.round(out['logl'][1], 2).tolist()}, mv logl "
              f"{np.round(out['mv_logl'][1], 2).tolist()}", flush=True)
    return out


def _check(what, logls, iteration):
    if iteration != 2:
        raise AssertionError(f"{what}: {iteration} iterations run, not 2")
    if not bool(torch.isfinite(logls[0]).all()):
        raise AssertionError(f"{what}: non-finite loglikelihood")
    if not bool((logls[1] >= logls[0] - 1e-3).all()):
        raise AssertionError(f"{what}: loglikelihood regressed")
