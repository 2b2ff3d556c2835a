"""Result container + pretty printing (reference
src/data_structures.jl:245-357); host numpy, as in the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IHTResult:
    """Univariate IHT fit result (reference IHTResult, data_structures.jl:245-258)."""
    time: float
    logl: float
    iter: int
    beta: np.ndarray          # (p,)
    c: np.ndarray             # (q,)
    J: int
    k: object                 # int or list for group IHT
    group: np.ndarray | None
    d: object                 # distribution object
    sigma_g: float            # proportion of phenotypic variance explained

    @property
    def sigma(self):  # alias
        return self.sigma_g

    def __str__(self):
        snp_pos = np.flatnonzero(self.beta)
        cov_pos = np.flatnonzero(self.c)
        lines = [
            "",
            f"IHT estimated {len(snp_pos)} nonzero SNP predictors and "
            f"{len(cov_pos)} non-genetic predictors.",
            "",
            f"Compute time (sec):     {self.time}",
            f"Final loglikelihood:    {self.logl}",
            f"SNP PVE:                {self.sigma_g}",
            f"Iterations:             {self.iter}",
            "",
            "Selected genetic predictors:",
            _table(snp_pos + 1, self.beta[snp_pos]),
            "",
            "Selected nongenetic predictors:",
            _table(cov_pos + 1, self.c[cov_pos]),
        ]
        return "\n".join(lines)

    __repr__ = __str__


def _table(positions, values):
    rows = [" Row │ Position  Estimated_β"]
    rows.append("─" * 30)
    for i, (pos, v) in enumerate(zip(positions, values)):
        rows.append(f"{i+1:4d} │ {pos:8d}  {v: .6g}")
    return "\n".join(rows)


def print_cv_results(io, errors, path, k):
    print("\n\nCrossvalidation Results:", file=io)
    print("\tk\tMSE", file=io)
    for ki, e in zip(path, errors):
        print(f"\t{ki}\t{e}", file=io)
    print(f"\nBest k = {k}\n", file=io)


def print_a_bunch_of_path_results(io, loglikelihoods, path):
    print("\n\nResults of running all the model sizes specified in `path`:", file=io)
    print("\tk\tloglikelihoods", file=io)
    for ki, l in zip(path, loglikelihoods):
        print(f"\t{ki}\t{l}", file=io)
    print("\nWe recommend running cross validation through `cv_iht` on "
          "appropriate model sizes, which is roughly the values of k where the "
          "loglikelihood stop increasing significantly.", file=io)
