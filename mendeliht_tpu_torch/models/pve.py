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
