"""Negative-binomial nuisance parameter (r) estimation: MM and Newton.

Reference: src/utilities.jl:141-247 (``mle_for_r``, ``update_r_MM``,
``update_r_newton``); the JAX package's ``ops/negbin.py`` step for step.
Batched over the task axis; the inner counting sum ``sum_{j=0}^{y-1}
r/(r+j)`` is evaluated in closed form via digamma: ``r * (psi(r+y) -
psi(r))``.

Reference quirks replicated on purpose:
  * the derivative sums ignore the cross-validation mask (the reference
    loops over all samples) -- only the linesearch loglikelihood is
    cv-weighted;
  * the Newton linesearch step size persists across Newton iterations
    within a call, starting at 1 for each call.

The JAX package runs Newton's iterations in a ``while_loop`` with a scan of
20 step halvings inside.  Here the 20 halvings of one iteration are one
batch of candidates, evaluated together, and the host reads one flag per
Newton iteration (``done.all()``): a loop that synced per halving would
cost thousands of host round trips per fit, since ``_take_step``
re-estimates r on every step and every backtrack.
"""

from __future__ import annotations

import torch

from . import glm

_HALVINGS = 20


def update_r_mm(y, mu, r, sample_mask):
    """One MM update of r (reference src/utilities.jl:158-173).

    y (n_pad,), mu (B, n_pad), r (B,), sample_mask (n_pad,) -> (B,).
    """
    yb = y[None, :]
    rc = r[:, None]
    num = rc * (torch.digamma(rc + yb) - torch.digamma(rc))
    num = (num * sample_mask[None, :]).sum(dim=1)
    den = (torch.log(rc / (rc + mu)) * sample_mask[None, :]).sum(dim=1)
    return -num / den


def _d1(y, mu, r, mask):
    t = (-(y + r) / (mu + r) - torch.log(mu + r) + 1.0 + torch.log(r)
         + torch.digamma(r + y) - torch.digamma(r))
    return (t * mask).sum(dim=-1)


def _d2(y, mu, r, mask):
    t = ((y + r) / (mu + r) ** 2 - 2.0 / (mu + r) + 1.0 / r
         + torch.polygamma(1, r + y) - torch.polygamma(1, r))
    return (t * mask).sum(dim=-1)


def update_r_newton(y, mu, r, sample_mask, cv_wts, n_true,
                    max_iter=100, conv_tol=1e-6):
    """Newton update with backtracking linesearch (reference
    src/utilities.jl:180-247).  y (n_pad,), mu (B, n_pad), r (B,),
    sample_mask (n_pad,), cv_wts (B, n_pad) -> (B,).

    Each Newton iteration tries r - step 2^-j inc for j = 0..19 at once and
    takes the first j whose loglikelihood beats the current one, with the
    step it was taken at; where none does, r - step 2^-20 inc with step
    2^-20, which is what the JAX package's scan of 20 halvings leaves."""
    yb = y[None, :]
    mask = sample_mask[None, :]
    # (J + 1, 1) halving factors 2^-j, j = 0..J
    halve = torch.pow(0.5, torch.arange(_HALVINGS + 1, dtype=r.dtype,
                                        device=r.device))[:, None]

    def nb_logl(rv):
        # rv (..., B) -> (..., B)
        return glm.loglikelihood("negativebinomial", yb, mu, cv_wts, n_true,
                                 nb_r=rv[..., None], dim=-1)

    step = torch.ones_like(r)
    done = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    for _ in range(max_iter):
        rc = r[:, None]
        dx = _d1(yb, mu, rc, mask)
        dx2 = _d2(yb, mu, rc, mask)
        inc = torch.where(dx2 < 0, dx / dx2, dx)
        old_logl = nb_logl(r)

        steps = step[None, :] * halve                      # (J + 1, B)
        cand = r[None, :] - steps * inc[None, :]
        accept = (cand > 0) & (old_logl[None, :] < nb_logl(
            torch.clamp(cand, min=1e-8)))
        accept[-1] = True               # row J: what is left if none is
        first = accept.to(torch.int8).argmax(dim=0, keepdim=True)
        step = steps.gather(0, first)[0]
        new_r = cand.gather(0, first)[0]

        conv = (r - new_r).abs() <= conv_tol
        r = torch.where(done, r, new_r)
        done = done | conv
        if bool(done.all()):
            break
    return r


def mle_for_r(est_r: str, y, mu, r, sample_mask, cv_wts, n_true):
    if est_r == "mm":
        return update_r_mm(y, mu, r, sample_mask)
    if est_r == "newton":
        return update_r_newton(y, mu, r, sample_mask, cv_wts, n_true)
    raise ValueError(f"est_r must be 'mm' or 'newton', got {est_r}")
