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
from .fit import _NOT_PORTED, build_fit, check_not_ported
from .initialize import init_state
from .results import print_a_bunch_of_path_results, print_cv_results
from .univariate import (cv_fused, finalize_iht, predict_deviance, run_iht,
                         run_segment)

_CV_NOT_PORTED = {
    **{name: _NOT_PORTED[name] for name in (
        "est_r", "group", "weight", "zkeep", "debias", "init_beta",
        "checkpoint_dir")},
    "checkpoint_every": ((20,), "Queue 1 item 12 (checkpointing)"),
}
_PATH_NOT_PORTED = {name: _NOT_PORTED[name] for name in (
    "est_r", "group", "weight", "use_maf", "debias")}


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


def cv_iht(y, x, z=None, d=None, l=None, path=None, q=5, folds=None,
           verbose=True, max_iter=100, min_iter=5, rng=None,
           show_progress=False, **not_ported):
    """q-fold cross validation over a path of sparsity levels; returns the
    vector of fold-size-weighted holdout deviances per k (reference
    src/cross_validation.jl:60-131).

    ``x`` is a PackedGenotypes (or a PackedOp); the solve runs on its
    device.  ``folds`` (n,) in 1..q, else drawn from ``rng`` (a numpy
    Generator).  Only the resident Normal/identity path is ported; the JAX
    package's other arguments raise NotImplementedError naming the ROADMAP
    item that ports them."""
    check_not_ported("cv_iht", not_ported, _CV_NOT_PORTED)
    y_arr = np.asarray(y)
    if y_arr.ndim == 2 and y_arr.shape[0] > 1 and y_arr.shape[1] > 1:
        raise NotImplementedError("multivariate cv_iht is not ported yet: "
                                  "ROADMAP Queue 1 item 10 (multivariate)")
    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(y, x, z, k=max(path), d=d, l=l,
                                 max_iter=max_iter, min_iter=min_iter)
    if max(path) > op.p:
        raise ValueError("Sparsity level in `path` cannot be larger than "
                         "total number of variables")

    n = op.n
    if folds is None:
        rng = np.random.default_rng() if rng is None else rng
        folds = rng.integers(1, q + 1, size=n)
    folds = np.asarray(folds)

    combos = allocate_fold_and_k(q, path)
    B = len(combos)
    ks = torch.as_tensor([k for _, k in combos], dtype=torch.int64,
                         device=op.device)
    train = np.zeros((B, op.n_pad), np.float32)
    test = np.zeros((B, op.n_pad), np.float32)
    for i, (fold, _) in enumerate(combos):
        train[i, :n] = folds != fold
        test[i, :n] = folds == fold
    kw = dict(dtype=op.dtype, device=op.device)
    train, test = torch.as_tensor(train, **kw), torch.as_tensor(test, **kw)

    t0 = _time.time()
    if show_progress:
        mses = _cv_progress(op, data, cfg, ks, train, test)
    else:
        mses = cv_fused(op, data, cfg, ks, train, test)
    mses = mses.cpu().numpy()
    elapsed = _time.time() - t0

    mse = meanloss(mses, q, folds)
    best_k = path[int(np.argmin(mse))]
    if verbose:
        print_cv_results(sys.stdout, mse, path, best_k)
        print(f"Cross validation took {elapsed:.3f} seconds")
    return mse


def _cv_progress(op, data, cfg, ks, train, test, step=5):
    """Segmented solve with a live progress display to stderr (the
    reference's ProgressMeter over (fold, k) fits,
    src/cross_validation.jl:95; here tasks converge in lockstep, so
    progress is the converged-task count per segment of ``step``
    iterations)."""
    B = int(ks.shape[0])
    # \r-style updates only on an interactive terminal; plain lines when
    # stderr is redirected to a file
    tty = getattr(sys.stderr, "isatty", lambda: False)()
    st = init_state(op, data, cfg, ks, train)
    while st.iteration < cfg.max_iter - 1:
        st = run_segment(op, data, cfg, st,
                         min(st.iteration + step, cfg.max_iter - 1))
        n_active = int(st.active.sum())
        msg = (f"Cross-validating: iteration {st.iteration:4d}, "
               f"{B - n_active}/{B} models converged")
        if tty:
            print("\r" + msg, end="", file=sys.stderr, flush=True)
        else:
            print(msg, file=sys.stderr, flush=True)
        if n_active == 0:
            break
    if tty:
        print(file=sys.stderr)
    st = finalize_iht(op, data, cfg, st)
    return predict_deviance(op, data, cfg, st, test)


def iht_run_many_models(y, x, z=None, d=None, l=None, path=None,
                        verbose=True, parallel=True, max_iter=100,
                        **not_ported):
    """Fit every k in ``path`` on the full data (no holdout) and return the
    loglikelihoods (reference src/cross_validation.jl:232-277).  All models
    run as one batch of tasks."""
    check_not_ported("iht_run_many_models", not_ported, _PATH_NOT_PORTED)
    if not parallel:
        warnings.warn(
            "iht_run_many_models(parallel=False) is ignored: all path models "
            "run as one batch of tasks (inherently parallel); there is no "
            "serial mode.", stacklevel=2)
    d = d if d is not None else glm.Normal()
    path = list(path) if path is not None else list(range(1, 21))
    op, data, cfg, _ = build_fit(y, x, z, k=max(path), d=d, l=l,
                                 max_iter=max_iter)

    B = len(path)
    cv_wts = data.sample_mask[None, :].expand(B, op.n_pad)
    st = init_state(op, data, cfg, path, cv_wts)
    st = run_iht(op, data, cfg, st)
    logls = st.best_logl.cpu().numpy().astype(np.float64)
    if verbose:
        print_a_bunch_of_path_results(sys.stdout, logls, path)
    return logls
