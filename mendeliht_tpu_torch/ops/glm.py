"""GLM distributions and link functions as elementwise tensor functions.

Mirrors the reference's GLM layer (src/utilities.jl:30-43 loglik_obs, :52-61
deviance, :68-82 linkinv, :126-135 score weights ``mueta/glmvar``) and the
JAX package's ``ops/glm.py`` as name-keyed functions, so that the family is
a configuration string while the negative-binomial nuisance ``nb_r`` is a
tensor.  The distribution and link classes mirror the Distributions.jl
surface and are lowered to their names at once.  All ops are NaN-safe
under 0-weight masking (cross-validation holdout samples multiply by
``wt == 0``): any term that could be +-inf is zeroed with ``where`` before
the weight multiplies it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# ---------------------------------------------------------------------------
# user-facing distribution / link objects (mirror Distributions.jl surface)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Distribution:
    name = "abstract"


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    name = "normal"


@dataclasses.dataclass(frozen=True)
class Bernoulli(Distribution):
    name = "bernoulli"


@dataclasses.dataclass(frozen=True)
class Poisson(Distribution):
    name = "poisson"


@dataclasses.dataclass(frozen=True)
class NegativeBinomial(Distribution):
    name = "negativebinomial"
    r: float = 1.0
    p: float = 0.5


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    name = "gamma"


@dataclasses.dataclass(frozen=True)
class InverseGaussian(Distribution):
    name = "inversegaussian"


@dataclasses.dataclass(frozen=True)
class Binomial(Distribution):
    name = "binomial"


@dataclasses.dataclass(frozen=True)
class MvNormal(Distribution):
    """Marker for joint multivariate-Gaussian (multi-trait) analysis."""
    name = "mvnormal"


class Link:
    name = "abstract"


def _mk_link(nm):
    cls = type(f"{nm.capitalize()}Link", (Link,), {"name": nm})
    cls.__eq__ = lambda self, other: (isinstance(other, Link)
                                      and other.name == self.name)
    cls.__hash__ = lambda self: hash(self.name)
    cls.__repr__ = lambda self: f"{nm.capitalize()}Link()"
    return cls


IdentityLink = _mk_link("identity")
LogitLink = _mk_link("logit")
LogLink = _mk_link("log")
InverseLink = _mk_link("inverse")
SqrtLink = _mk_link("sqrt")
ProbitLink = _mk_link("probit")
CloglogLink = _mk_link("cloglog")
InverseSquareLink = _mk_link("inversesquare")

# canonical link of every family (by name)
_CANONICAL = {
    "normal": "identity",
    "bernoulli": "logit",
    "binomial": "logit",
    "poisson": "log",
    "negativebinomial": "log",  # reference recommends LogLink (wrapper.jl:87)
    "gamma": "inverse",
    "inversegaussian": "inversesquare",
    "mvnormal": "identity",
}

_LINKS = {
    "identity": IdentityLink, "logit": LogitLink, "log": LogLink,
    "inverse": InverseLink, "sqrt": SqrtLink, "probit": ProbitLink,
    "cloglog": CloglogLink, "inversesquare": InverseSquareLink,
}


def canonicallink(d) -> Link:
    return _LINKS[_CANONICAL[dist_name(d)]]()


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


# ---------------------------------------------------------------------------
# elementwise functions
# ---------------------------------------------------------------------------

def _ndtr(x):
    """The standard normal cdf by the JAX package's formula
    (``jax.scipy.special.ndtr``): 1 + erf near 0, 2 - erfc above, erfc
    below, halved, so that it saturates where the JAX one does."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + torch.erf(w),
                    torch.where(w > 0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def _norm_pdf(x):
    """exp(-(log(2 pi) + x^2) / 2), the JAX package's
    ``jax.scipy.stats.norm.pdf`` formula."""
    log_normalizer = torch.log(torch.full_like(x, 2.0 * math.pi))
    return torch.exp((log_normalizer + x * x) / -2.0)


def linkinv(link: str, eta):
    """mu = g^{-1}(eta)."""
    if link == "identity":
        return eta
    if link == "logit":
        return 1.0 / (1.0 + torch.exp(-eta))
    if link == "log":
        return torch.exp(eta)
    if link == "inverse":
        return 1.0 / eta
    if link == "sqrt":
        return eta * eta
    if link == "probit":
        return _ndtr(eta)
    if link == "cloglog":
        return -torch.expm1(-torch.exp(eta))
    if link == "inversesquare":
        return 1.0 / torch.sqrt(eta)
    raise ValueError(f"unknown link {link}")


def mueta(link: str, eta):
    """d mu / d eta."""
    if link == "identity":
        return torch.ones_like(eta)
    if link == "logit":
        e = torch.exp(-eta.abs())
        return e / (1.0 + e) ** 2
    if link == "log":
        return torch.exp(eta)
    if link == "inverse":
        return -1.0 / (eta * eta)
    if link == "sqrt":
        return 2.0 * eta
    if link == "probit":
        return _norm_pdf(eta)
    if link == "cloglog":
        return torch.exp(eta - torch.exp(eta))
    if link == "inversesquare":
        return -0.5 * eta ** (-1.5)
    raise ValueError(f"unknown link {link}")


def glmvar(dist: str, mu, nb_r=None):
    """GLM variance function V(mu)."""
    if dist == "normal":
        return torch.ones_like(mu)
    if dist in ("bernoulli", "binomial"):
        return mu * (1.0 - mu)
    if dist == "poisson":
        return mu
    if dist == "negativebinomial":
        return mu + mu * mu / nb_r
    if dist == "gamma":
        return mu * mu
    if dist == "inversegaussian":
        return mu * mu * mu
    raise ValueError(f"unknown distribution {dist}")


def _bernoulli_ll(y, mu):
    """y log mu + (1 - y) log(1 - mu), mu clipped to [1e-10, 1 - 1e-10]."""
    mu_c = torch.clamp(mu, 1e-10, 1.0 - 1e-10)
    return torch.special.xlogy(y, mu_c) + torch.special.xlog1py(1.0 - y, -mu_c)


def devresid(dist: str, y, mu, nb_r=None):
    """Squared deviance residual per observation (GLM.jl's devresid)."""
    if dist == "normal":
        d = y - mu
        return d * d
    if dist == "bernoulli":
        return -2.0 * _bernoulli_ll(y, mu)
    if dist == "poisson":
        return 2.0 * (torch.special.xlogy(y, y / torch.clamp(mu, min=1e-30))
                      - (y - mu))
    if dist == "negativebinomial":
        return 2.0 * (torch.special.xlogy(y, y / torch.clamp(mu, min=1e-30))
                      - (y + nb_r) * torch.log((y + nb_r) / (mu + nb_r)))
    if dist == "gamma":
        return -2.0 * (torch.log(y / mu) - (y - mu) / mu)
    if dist == "inversegaussian":
        d = y - mu
        return d * d / (y * mu * mu)
    raise ValueError(f"unknown distribution {dist}")


def loglik_obs(dist: str, y, mu, wt, phi, nb_r=None):
    """Weighted per-observation loglikelihood (reference
    src/utilities.jl:30-43).  ``wt`` is the 0/1 sample mask, ``phi`` the
    dispersion (deviance / n), used by normal, gamma and inverse Gaussian."""
    if dist == "normal":
        ll = -0.5 * (torch.log(2.0 * math.pi * phi) + (y - mu) ** 2 / phi)
    elif dist == "bernoulli":
        ll = _bernoulli_ll(y, mu)
    elif dist == "poisson":
        ll = torch.special.xlogy(y, mu) - mu - torch.lgamma(y + 1.0)
    elif dist == "negativebinomial":
        # reference parameterization: p = r/(mu+r)   (src/utilities.jl:38-43)
        r = nb_r
        ll = (torch.lgamma(y + r) - torch.lgamma(r) - torch.lgamma(y + 1.0)
              + r * torch.log(r / (mu + r))
              + torch.special.xlogy(y, mu / (mu + r)))
    elif dist == "gamma":
        # Gamma(shape=1/phi, scale=mu*phi)
        a = 1.0 / phi
        theta = mu * phi
        ll = (-torch.lgamma(a) - a * torch.log(theta)
              + torch.special.xlogy(a - 1.0, y) - y / theta)
    elif dist == "inversegaussian":
        lam = 1.0 / phi
        ll = (0.5 * (torch.log(lam) - math.log(2.0 * math.pi)
                     - 3.0 * torch.log(y))
              - lam * (y - mu) ** 2 / (2.0 * mu * mu * y))
    elif dist == "binomial":
        # loglik_obs(::Binomial...) treats wt as the trial count
        # (reference src/utilities.jl:33)
        n_tr = wt
        k = y * wt
        mu_c = torch.clamp(mu, 1e-10, 1.0 - 1e-10)
        return (torch.lgamma(n_tr + 1) - torch.lgamma(k + 1)
                - torch.lgamma(n_tr - k + 1) + torch.special.xlogy(k, mu_c)
                + torch.special.xlog1py(n_tr - k, -mu_c))
    else:
        raise ValueError(f"unknown distribution {dist}")
    ll = torch.where(wt > 0, ll, torch.zeros_like(ll))
    return wt * ll


def deviance(dist: str, y, mu, wts, nb_r=None, dim=None):
    """Weighted sum of squared deviance residuals (src/utilities.jl:52-61)."""
    d = devresid(dist, y, mu, nb_r=nb_r)
    d = torch.where(wts > 0, d, torch.zeros_like(d))
    out = wts * d
    return out.sum() if dim is None else out.sum(dim=dim)


def loglikelihood(dist: str, y, mu, wts, n_true, nb_r=None, dim=None):
    """Total weighted loglikelihood with phi = deviance / length(y)
    (reference src/utilities.jl:9-20: divides by the FULL length, not the
    masked count)."""
    phi = deviance(dist, y, mu, wts, nb_r=nb_r, dim=dim) / n_true
    if dim is not None:
        phi = phi.unsqueeze(dim)
    phi = torch.clamp(phi, min=1e-30)
    ll = loglik_obs(dist, y, mu, wts, phi, nb_r=nb_r)
    return ll.sum() if dim is None else ll.sum(dim=dim)


def score_residual(dist: str, link: str, y, mu, eta, wts, nb_r=None):
    """w * (y - mu) with w = mueta(eta)/glmvar(mu), masked by the sample
    weights (reference score!, src/utilities.jl:126-135)."""
    w = mueta(link, eta) / torch.clamp(glmvar(dist, mu, nb_r=nb_r),
                                       min=1e-30)
    return w * (y - mu) * wts
