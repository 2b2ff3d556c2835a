"""Proportion of variance explained (chip heritability), reference src/pve.jl.

pve = Var(mu_hat) / Var(y) with mu_hat = g^-1(X beta), the genotype-only
linear predictor (reference save_best_model! + pve(v),
src/utilities.jl:1004-1005, src/pve.jl:32-38).  Sample variance with the
n-1 divisor over the true (unpadded) samples, without sample masking."""

from __future__ import annotations


def masked_var(x, mask, n_true, dim=-1):
    xb = (x * mask).sum(dim=dim, keepdim=True) / n_true
    ss = (((x - xb) ** 2) * mask).sum(dim=dim)
    return ss / (n_true - 1)


def pve(y, mu, sample_mask, n_true):
    """y (n_pad,); mu (n_pad,) or (B, n_pad) -> scalar or (B,)."""
    return (masked_var(mu, sample_mask, n_true)
            / masked_var(y, sample_mask, n_true))


def pve_from_model(y, X, beta, l=None):
    """Public ``pve(y, X, beta; l)`` (reference src/pve.jl:12-20):
    Var(g^-1(X beta)) / Var(y) with the n-1 divisor, on the host in
    float64.  X is a PackedGenotypes (standardized and mean-imputed here)
    or a dense (n, p) array or tensor; y (n,) gives a float, y (n, r) a list of r."""
    import numpy as np
    import torch

    from ..genotype.snparray import PackedGenotypes
    from ..ops import glm

    link = glm.link_name(l) if l is not None else "identity"
    if isinstance(X, PackedGenotypes):
        Xd = X.to_dense_standardized()
    elif isinstance(X, torch.Tensor):
        Xd = X.cpu().double().numpy()
    else:
        Xd = np.asarray(X)
    y = np.asarray(y)
    mu = glm.linkinv(link, torch.from_numpy(
        np.asarray(Xd @ np.asarray(beta)))).numpy()
    if y.ndim == 1:
        return float(np.var(mu, ddof=1) / np.var(y, ddof=1))
    return [float(np.var(mu[:, i], ddof=1) / np.var(y[:, i], ddof=1))
            for i in range(y.shape[1])]
