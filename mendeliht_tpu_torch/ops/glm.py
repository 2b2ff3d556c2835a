"""GLM distributions and link functions as elementwise tensor functions.

Mirrors the reference's GLM layer (src/utilities.jl:30-43 loglik_obs, :52-61
deviance, :68-82 linkinv, :126-135 score weights ``mueta/glmvar``) as
name-keyed functions.  Only the Normal family with its identity link is
ported so far; every other family or link raises.  All ops are NaN-safe
under 0-weight masking: a term is zeroed with ``where`` before the weight
multiplies it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LATER = "is not ported yet: ROADMAP Queue 1 item 9 (other GLM families)"


@dataclasses.dataclass(frozen=True)
class Distribution:
    name = "abstract"


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    name = "normal"


class Link:
    name = "abstract"


class IdentityLink(Link):
    name = "identity"

    def __repr__(self):
        return "IdentityLink()"


# canonical link of every family the JAX package supports (by name)
_CANONICAL = {
    "normal": "identity",
    "bernoulli": "logit",
    "binomial": "logit",
    "poisson": "log",
    "negativebinomial": "log",
    "gamma": "inverse",
    "inversegaussian": "inversesquare",
    "mvnormal": "identity",
}


def dist_name(d) -> str:
    if isinstance(d, str):
        return d.lower()
    if isinstance(d, Distribution):
        return d.name
    if isinstance(d, type) and issubclass(d, Distribution):
        return d.name
    raise TypeError(f"not a distribution: {d!r}")


def link_name(l) -> str:
    if l is None:
        return "identity"
    if isinstance(l, str):
        return l.lower()
    if isinstance(l, Link):
        return l.name
    if isinstance(l, type) and issubclass(l, Link):
        return l.name
    raise TypeError(f"not a link: {l!r}")


def linkinv(link: str, eta):
    """mu = g^{-1}(eta)."""
    if link == "identity":
        return eta
    raise NotImplementedError(f"link {link} {_LATER}")


def mueta(link: str, eta):
    """d mu / d eta."""
    if link == "identity":
        return torch.ones_like(eta)
    raise NotImplementedError(f"link {link} {_LATER}")


def glmvar(dist: str, mu):
    """GLM variance function V(mu)."""
    if dist == "normal":
        return torch.ones_like(mu)
    raise NotImplementedError(f"distribution {dist} {_LATER}")


def devresid(dist: str, y, mu):
    """Squared deviance residual per observation (GLM.jl's devresid)."""
    if dist == "normal":
        d = y - mu
        return d * d
    raise NotImplementedError(f"distribution {dist} {_LATER}")


def loglik_obs(dist: str, y, mu, wt, phi):
    """Weighted per-observation loglikelihood (reference
    src/utilities.jl:30-43).  ``wt`` is the 0/1 sample mask, ``phi`` the
    dispersion (deviance / n)."""
    if dist == "normal":
        ll = -0.5 * (torch.log(2.0 * math.pi * phi) + (y - mu) ** 2 / phi)
    else:
        raise NotImplementedError(f"distribution {dist} {_LATER}")
    ll = torch.where(wt > 0, ll, torch.zeros_like(ll))
    return wt * ll


def deviance(dist: str, y, mu, wts, dim=None):
    """Weighted sum of squared deviance residuals (src/utilities.jl:52-61)."""
    d = devresid(dist, y, mu)
    d = torch.where(wts > 0, d, torch.zeros_like(d))
    out = wts * d
    return out.sum() if dim is None else out.sum(dim=dim)


def loglikelihood(dist: str, y, mu, wts, n_true, dim=None):
    """Total weighted loglikelihood with phi = deviance / length(y)
    (reference src/utilities.jl:9-20: divides by the FULL length, not the
    masked count)."""
    phi = deviance(dist, y, mu, wts, dim=dim) / n_true
    if dim is not None:
        phi = phi.unsqueeze(dim)
    phi = torch.clamp(phi, min=1e-30)
    ll = loglik_obs(dist, y, mu, wts, phi)
    return ll.sum() if dim is None else ll.sum(dim=dim)


def score_residual(dist: str, link: str, y, mu, eta, wts):
    """w * (y - mu) with w = mueta(eta)/glmvar(mu), masked by the sample
    weights (reference score!, src/utilities.jl:126-135)."""
    w = mueta(link, eta) / torch.clamp(glmvar(dist, mu), min=1e-30)
    return w * (y - mu) * wts
