"""The reference of a ``fit_iht`` call on a Gaussian model with the
identity link (``iht.fit``), what is taken from the program's answer, and
the numbers that decide ``correct``.

- ``coef_gap``: the largest difference of an effect over the union of both
  supports, the intercept among them, over the reference's largest effect;
  a SNP selected by one side only counts with its whole effect.
- ``logl_gap``: the loglikelihoods' difference over the reference's.
"""

from __future__ import annotations

import numpy as np

from . import iht

FAMILIES = (("Normal", "IdentityLink"),)
ARGS = ("k", "max_iter", "verbose", "dtype")   # the call arguments it follows
prepare = iht.Genotypes


def answer(result) -> dict:
    """What is compared of the program's ``fit_iht`` result."""
    sel = np.flatnonzero(result.beta)
    return dict(support=sel, beta=result.beta[sel], c=float(result.c[0]),
                logl=float(result.logl), iter=result.iter)


def run(G, y, folds, args: dict) -> dict:
    """The reference's answer to the call on ``G`` (``prepare``'s)."""
    return iht.fit(G, y, args.get("k", 10), args.get("max_iter", 200))


def compare(got: dict, ref: dict) -> dict:
    union = np.union1d(got["support"], ref["support"])

    def effects(a):
        out = np.zeros(len(union) + 1)
        out[np.searchsorted(union, a["support"])] = a["beta"]
        out[-1] = a["c"]
        return out

    g, r = effects(got), effects(ref)
    return {"coef_gap": float(np.max(np.abs(g - r)) / np.max(np.abs(r))),
            "logl_gap": float(abs(got["logl"] - ref["logl"])
                              / abs(ref["logl"]))}
