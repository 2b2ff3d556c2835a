"""The reference of a ``cv_iht`` call on a Gaussian model with the
identity link and given folds (``iht.cv``), what is taken from the
program's answer, and the number that decides ``correct``.

- ``mse_gap``: the largest difference over the path of the holdout mse,
  each over the reference's.  It bounds the best k too: with every mse
  within a share L of the reference's, the program's best k has a
  reference mse within about 2L of the reference's best.
"""

from __future__ import annotations

import numpy as np

from . import iht

FAMILIES = (("Normal", "IdentityLink"),)
ARGS = ("path", "q", "max_iter", "verbose", "dtype")
prepare = iht.Genotypes


def answer(result) -> dict:
    """What is compared of the program's ``cv_iht`` result."""
    return dict(mse=np.asarray(result, np.float64))


def run(G, y, folds, args: dict) -> dict:
    return dict(mse=iht.cv(G, y, folds, args["path"], args.get("q", 5),
                           args.get("max_iter", 100)))


def compare(got: dict, ref: dict) -> dict:
    g = np.asarray(got["mse"], np.float64)
    r = np.asarray(ref["mse"], np.float64)
    return {"mse_gap": float(np.max(np.abs(g - r) / r))}
