"""Cross-validation over (fold, sparsity) combinations (reference
src/cross_validation.jl:60-131, :217-223, :279-320; the JAX package's
``models/cv.py``).

The (fold, k) combinations form the batch axis B of one solve: every score
pass is one multi-RHS decode-score at RHS width m = B for all combinations
at once, and fold masking uses the reference's 0/1 ``cv_wts``, so no
genotype data moves.  Folds are drawn as in the JAX package
(``rng.integers(1, q + 1, size=n)`` on a numpy Generator), so a seed gives
the same folds in both packages."""

from __future__ import annotations

import sys
import time as _time
import warnings

import numpy as np
import torch

from ..ops import glm
from .fit import build_fit, is_multivariate
from .initialize import init_state
from .results import print_a_bunch_of_path_results, print_cv_results
from .univariate import _all_tasks, cv_fused, run_iht
from ..utils.device import float_dtype


def allocate_fold_and_k(q: int, path):
    """All (fold, k) combinations (reference src/cross_validation.jl:217-223)."""
    return [(fold, k) for fold in range(1, q + 1) for k in path]


def meanloss(fitloss, q, folds):
    """Fold-size weighted average of per-combination losses
    (reference src/cross_validation.jl:304-320)."""
    fitloss = np.asarray(fitloss, np.float64)
    folds = np.asarray(folds)
    ninfold = np.bincount(folds, minlength=q + 1)[1:]
    pathsize = len(fitloss) // q
    loss = np.zeros(pathsize)
    for j in range(q):
        w = ninfold[j] / len(folds)
        loss += fitloss[j * pathsize:(j + 1) * pathsize] * w
    return loss


def _task_masks(op, q, path, folds, rng):
    """The (fold, k) tasks of a cv on ``op``'s samples: (folds (n,), drawn
    from ``rng`` as the JAX package draws them when None; each task's k
    (B,); its 0/1 train and test masks (B, n_pad) in ``op``'s dtype), on
    ``op``'s device."""
    n = op.n
    if folds is None:
        rng = np.random.default_rng() if rng is None else rng
        folds = rng.integers(1, q + 1, size=n)
    folds = np.asarray(folds)
    combos = allocate_fold_and_k(q, path)
    train = np.zeros((len(combos), op.n_pad),
                     torch.empty((), dtype=op.dtype).numpy().dtype)
    test = np.zeros_like(train)
    for i, (fold, _) in enumerate(combos):
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold
    ks = torch.as_tensor([k for _, k in combos], dtype=torch.int64,
                         device=op.device)
    kw = dict(dtype=op.dtype, device=op.device)
    return (folds, ks, torch.as_tensor(train, **kw),
            torch.as_tensor(test, **kw))


def cv_iht(y, x, z=None, d=None, l=None, path=None, q=5, est_r="none",
           group=None, weight=None, zkeep=None, folds=None, debias=False,
           verbose=True, max_iter=100, min_iter=5, init_beta=False,
           memory_efficient=True, dtype=torch.float32, rng=None,
           checkpoint_dir=None, checkpoint_every=20, show_progress=False,
           use_maf=False):
    """q-fold cross validation over a path of sparsity levels; returns the
    vector of fold-size-weighted holdout deviances per k (reference
    src/cross_validation.jl:60-131).

    ``x`` is a PackedGenotypes (or a PackedOp), a HostStreamedGenotypes
    (out of core) or a dense matrix, as in :func:`fit_iht`; the solve runs
    on its device.  ``folds`` (n,) in 1..q, else drawn from ``rng`` (a numpy
    Generator).  Every family and link of :func:`fit_iht` runs, with
    ``est_r``, ``group`` (one group kept, each path k a per-group cap, as
    in the JAX package), ``weight``, ``zkeep``, ``debias`` and
    ``init_beta`` (any family, as in the JAX package's cv); the holdout
    loss is the family's deviance.  ``use_maf``, which the JAX package's
    cv_iht does not take, is accepted and ignored as ``fit_iht`` ignores
    it.  As in the JAX package, ``memory_efficient`` is accepted and
    ignored, and so is ``checkpoint_every`` without a ``checkpoint_dir``;
    ``dtype`` is float32 or float64, as in :func:`fit_iht`.  With
    ``checkpoint_dir`` the solve saves
    its state there every ``checkpoint_every`` iterations and first
    resumes from the newest state saved there; ``show_progress`` prints
    the converged-task count to stderr (``univariate.run_segmented``, one
    solve for both).

    A y of shape (r, n), r > 1, is a multivariate cv
    (``models/mv.py::cv_mv_iht``, as the JAX package routes it): z is then
    (q, n), the loss the holdout mse, and ``d``, ``l``, ``est_r``,
    ``group``, ``weight`` and ``use_maf`` are ignored."""
    if is_multivariate(y):
        from .mv import cv_mv_iht
        return cv_mv_iht(y, x, z, path=path, q=q, folds=folds, zkeep=zkeep,
                         debias=debias, verbose=verbose, max_iter=max_iter,
                         min_iter=min_iter, init_beta=init_beta, dtype=dtype,
                         rng=rng, checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every,
                         show_progress=show_progress)
    dtype = float_dtype(dtype, "cv_iht")
    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(
        y, x, z, k=max(path), d=d, l=l, group=group, weight=weight,
        zkeep=zkeep, est_r=est_r, debias=debias, max_iter=max_iter,
        min_iter=min_iter, dtype=dtype)
    if max(path) > op.p:
        raise ValueError("Sparsity level in `path` cannot be larger than "
                         "total number of variables")

    folds, ks, train, test = _task_masks(op, q, path, folds, rng)

    t0 = _time.time()
    mses = cv_fused(op, data, cfg, ks, train, test, init_beta=init_beta,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every,
                    progress=show_progress, verbose=verbose).cpu().numpy()
    elapsed = _time.time() - t0

    mse = meanloss(mses, q, folds)
    best_k = path[int(np.argmin(mse))]
    if verbose:
        print_cv_results(sys.stdout, mse, path, best_k)
        print(f"Cross validation took {elapsed:.3f} seconds")
    return mse


def iht_run_many_models(y, x, z=None, d=None, l=None, path=None,
                        est_r="none", group=None, weight=None, use_maf=False,
                        debias=False, verbose=True, parallel=True,
                        max_iter=100, dtype=torch.float32):
    """Fit every k in ``path`` on the full data (no holdout) and return the
    loglikelihoods (reference src/cross_validation.jl:232-277).  All models
    run as one batch of tasks; ``group``, ``weight`` and ``debias`` as in
    :func:`cv_iht`, ``use_maf`` accepted and ignored as in the JAX
    package; ``dtype`` float32 or float64, as in :func:`fit_iht`."""
    dtype = float_dtype(dtype, "iht_run_many_models")
    if not parallel:
        warnings.warn(
            "iht_run_many_models(parallel=False) is ignored: all path models "
            "run as one batch of tasks (inherently parallel); there is no "
            "serial mode.", stacklevel=2)
    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(y, x, z, k=max(path), d=d, l=l, group=group,
                                 weight=weight, est_r=est_r, debias=debias,
                                 max_iter=max_iter, dtype=dtype)

    B = len(path)
    cv_wts = data.sample_mask[None, :].expand(B, op.n_pad)
    st = init_state(op, data, cfg, path, cv_wts)
    st = run_iht(op, data, cfg, st)
    logls = _all_tasks(op, st.best_logl).cpu().numpy().astype(np.float64)
    if verbose:
        print_a_bunch_of_path_results(sys.stdout, logls, path)
    return logls
