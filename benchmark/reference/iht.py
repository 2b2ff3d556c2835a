"""The plain reference: iterative hard thresholding for the Gaussian model
with the identity link and an intercept, in plain PyTorch (docs/math.md;
MendelIHT.jl ``fit_iht`` / ``cv_iht``, src/fit.jl, src/utilities.jl,
src/cross_validation.jl).

It takes the genotype words, the phenotypes and the folds, and nothing
that the program made: it decodes the words itself (``decode.py``, a
frozen copy), works out mu and 1/sd from its own genotype counts in
float64, and runs every product unquantised in ``dtype`` (float64 for the
reference; a lower precision for the control).  The (fold, k) tasks of a
cv ride one batch axis, each masked as it would run alone.

Per task, from b = 0 and the intercept c fitted to the training mean:

- score: df = X' W (y - mu), df2 = 1' W (y - mu), W the 0/1 training mask;
  at the start df keeps only its k largest entries;
- step size: eta = |df_S|^2 / |W^(1/2) (X_S df_S + df2)|^2 on the current
  support S (1e-8 where it is not finite);
- step: b = P_k(b + eta df), c = c + eta df2, P_k the k largest |b_j|;
  halve eta while the loglikelihood fell, at most ``max_step`` times;
- the Gaussian loglikelihood with the dispersion RSS / n profiled out;
- stop once the iterate moves less than ``tol`` (scaled by its size + 1)
  after ``min_iter`` iterations, and keep the best-loglikelihood iterate.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import decode

BLOCK_BYTES = 2 << 30       # decoded genotype values a score block holds


class Genotypes:
    """The standardized n x p genotype matrix of the quad words, decoded
    in blocks of SNPs; mu and 1/sd from its own counts (float64, the
    reference's formula), kept in ``dtype``."""

    def __init__(self, words: torch.Tensor, n: int, p: int, dtype):
        self.words, self.n, self.p, self.dtype = words, n, p, dtype
        item = torch.empty((), dtype=dtype).element_size()
        self.rows = max(1, BLOCK_BYTES // (4 * n * max(item, 4)))
        het, alt, mis = (np.zeros(4 * words.shape[0], np.int64)
                         for _ in range(3))
        for lo, c in self._blocks():
            for out, code in ((het, 2), (alt, 3), (mis, 1)):
                out[4 * lo:4 * lo + c.shape[0]] = (
                    (c == code).sum(dim=1).cpu().numpy())
        het, alt, mis = het[:p], alt[:p], mis[:p]
        obs = n - mis
        mu = np.where(obs > 0, (het + 2.0 * alt) / np.maximum(obs, 1), 0.0)
        sd = np.sqrt(np.maximum(mu * (1.0 - mu / 2.0), 0.0))
        inv_sd = np.where(sd > 0, 1.0 / np.where(sd > 0, sd, 1.0), 0.0)
        self.has_missing = bool(mis.sum() > 0)
        kw = dict(dtype=dtype, device=words.device)
        self.mu = torch.as_tensor(mu, **kw)
        self.inv_sd = torch.as_tensor(inv_sd, **kw)

    def _blocks(self):
        """(first quad row, codes (4c, n) uint8) of each block."""
        for lo in range(0, self.words.shape[0], self.rows):
            rows = decode.quad_rows_bytes(self.words[lo:lo + self.rows])
            yield lo, decode.codes(rows, self.n)

    def xtr(self, R: torch.Tensor) -> torch.Tensor:
        """X' R for R (B, n) -> (B, p)."""
        out = torch.empty((R.shape[0], 4 * self.words.shape[0]),
                          dtype=self.dtype, device=R.device)
        Rt = R.T.contiguous()
        for lo, c in self._blocks():
            v, miss = decode.values(c, self.dtype, self.has_missing)
            hi = min(4 * lo + c.shape[0], self.p)
            mu, inv = self.mu[4 * lo:hi, None], self.inv_sd[4 * lo:hi, None]
            a = v[:hi - 4 * lo] @ Rt                  # raw values' dots
            obs = Rt.sum(dim=0)[None, :]
            if self.has_missing:
                obs = obs - miss[:hi - 4 * lo] @ Rt
            out[:, 4 * lo:hi] = (inv * (a - mu * obs)).T
        return out[:, :self.p]

    def columns(self, idx: torch.Tensor) -> torch.Tensor:
        """Standardized columns X[:, idx] -> (B, K, n) for idx (B, K)."""
        c = decode.codes(decode.rows_of(self.words, idx), self.n)
        v, miss = decode.values(c, self.dtype)
        z = (v - self.mu[idx][..., None]) * self.inv_sd[idx][..., None]
        return torch.where(miss > 0, torch.zeros_like(z), z)

    def forward(self, idx, coef):
        """X[:, idx] coef per task: idx, coef (B, K) -> (B, n)."""
        return torch.einsum("bkn,bk->bn", self.columns(idx), coef)


def _loglik(y, mu, W, n):
    """Gaussian loglikelihood over the samples W holds, the dispersion
    RSS / n (n all samples, as the reference's loglik_obs)."""
    rss = (W * (y - mu) ** 2).sum(dim=1, keepdim=True)
    phi = torch.clamp(rss / n, min=1e-30)
    ll = -0.5 * (torch.log(2.0 * math.pi * phi) + (y - mu) ** 2 / phi)
    return (W * torch.where(W > 0, ll, torch.zeros_like(ll))).sum(dim=1)


def _top_k(v, k, kmax):
    """P_k per task: (projected v, slots idx (B, kmax), slot kept)."""
    idx = torch.topk(v.abs(), kmax, dim=1).indices
    vals = torch.gather(v, 1, idx)
    keep = (torch.arange(kmax, device=v.device)[None, :] < k[:, None])
    keep = keep & (vals != 0)
    out = torch.zeros_like(v).scatter(1, idx, torch.where(
        keep, vals, torch.zeros_like(vals)))
    return out, idx, keep


def _rows(mask, new, old):
    return torch.where(mask.reshape(-1, *([1] * (new.dim() - 1))), new, old)


def iht(G: Genotypes, y: np.ndarray, train: np.ndarray, ks, *,
        max_iter: int, min_iter: int = 5, max_step: int = 3,
        tol: float = 1e-4):
    """Run one task a row of ``train`` (B, n) 0/1 with sparsity ``ks[t]``.
    Returns (best b (B, p), best c (B,), best loglikelihood (B,),
    iterations (B,), the best model's mean X b + c (B, n))."""
    kw = dict(dtype=G.dtype, device=G.words.device)
    n = G.n
    W = torch.as_tensor(np.asarray(train, np.float64), **kw)
    y = torch.as_tensor(np.asarray(y, np.float64), **kw)[None, :]
    k = torch.as_tensor(list(ks), dtype=torch.int64, device=W.device)
    kmax = int(max(ks))
    B = W.shape[0]

    ybar = (W * y).sum(dim=1) / (W != 0).sum(dim=1).clamp(min=1)
    c = torch.zeros(B, **kw)
    for _ in range(20):                        # Newton on the identity link
        gap = c - ybar
        c = torch.where(gap.abs() < 1e-10, c, c - gap.clamp(-1.0, 1.0))
    b = torch.zeros((B, G.p), **kw)
    mu = c[:, None].expand(B, n)
    r = W * (y - mu)
    df, df2 = G.xtr(r), r.sum(dim=1)
    df, idx, keep = _top_k(df, k, kmax)
    has_c = torch.ones(B, dtype=torch.bool, device=W.device)
    logl = torch.full((B,), -math.inf, **kw)
    best = (b.clone(), c.clone(), logl.clone())
    active = torch.ones(B, dtype=torch.bool, device=W.device)
    iters = torch.zeros(B, dtype=torch.int64, device=W.device)
    it = 0
    while it < max_iter - 1 and bool(active.any()):
        up = active & (logl > best[2])
        best = (_rows(up, b, best[0]), _rows(up, c, best[1]),
                _rows(up, logl, best[2]))
        b0, c0 = b, c

        g = torch.gather(df, 1, idx) * keep
        g2 = torch.where(has_c, df2, torch.zeros_like(df2))
        xg = G.forward(idx, g) + g2[:, None]
        eta = ((g * g).sum(dim=1) + g2 * g2) / (W * xg * xg).sum(dim=1)
        eta = torch.where(torch.isfinite(eta), eta, torch.full_like(eta, 1e-8))

        def step(eta):
            bn, ix, kp = _top_k(b0 + eta[:, None] * df, k, kmax)
            cn = c0 + eta * df2
            m = G.forward(ix, torch.gather(bn, 1, ix) * kp) + cn[:, None]
            return [bn, cn, ix, kp, m, _loglik(y, m, W, n)]

        cur = step(eta)
        n_bt = torch.zeros(B, dtype=torch.int64, device=W.device)
        while True:
            need = active & (logl > cur[5]) & (n_bt < max_step)
            if not bool(need.any()):
                break
            eta = torch.where(need, eta / 2, eta)
            cur = [_rows(need, a, o) for a, o in zip(step(eta), cur)]
            n_bt = n_bt + need.to(torch.int64)
        b, c, idx, keep, mu, logl = [_rows(active, a, o) for a, o in zip(
            cur, [b, c, idx, keep, mu, logl])]
        has_c = c != 0
        r = W * (y - mu)
        df = _rows(active, G.xtr(r), df)
        df2 = _rows(active, r.sum(dim=1), df2)

        it += 1
        moved = torch.maximum((b - b0).abs().amax(dim=1), (c - c0).abs())
        size = torch.maximum(b0.abs().amax(dim=1), c0.abs())
        bad = active & ~torch.isfinite(logl)
        done = active & (((it >= min_iter) & (moved / (size + 1.0) < tol))
                         | bad)
        iters = torch.where(done, torch.full_like(iters, it), iters)
        active = active & ~done
    iters = torch.where(active, torch.full_like(iters, max_iter), iters)
    up = logl > best[2]
    b, c, logl = (_rows(up, b, best[0]), _rows(up, c, best[1]),
                  _rows(up, logl, best[2]))
    _, idx, keep = _top_k(b, torch.full_like(k, kmax), kmax)
    mu = G.forward(idx, torch.gather(b, 1, idx) * keep) + c[:, None]
    return b, c, logl, iters, mu


def fit(G: Genotypes, y, k: int, max_iter: int = 200) -> dict:
    """``fit_iht(y, x, k=k)``: the support, its effects, the intercept and
    the loglikelihood of the best iterate."""
    b, c, logl, iters, _ = iht(G, y, np.ones((1, G.n)), [k],
                               max_iter=max_iter)
    sel = torch.nonzero(b[0]).reshape(-1)
    return dict(support=sel.cpu().numpy(),
                beta=b[0, sel].double().cpu().numpy(),
                c=float(c[0]), logl=float(logl[0]), iter=int(iters[0]))


def cv(G: Genotypes, y, folds, path, q: int, max_iter: int = 100):
    """``cv_iht(y, x, path=path, q=q, folds=folds)``: the fold-size
    weighted holdout deviance of each k."""
    folds = np.asarray(folds)
    tasks = [(f, k) for f in range(1, q + 1) for k in path]
    train = np.stack([folds != f for f, _ in tasks]).astype(np.float64)
    _, _, _, _, mu = iht(G, y, train, [k for _, k in tasks],
                         max_iter=max_iter)
    kw = dict(dtype=mu.dtype, device=mu.device)
    test = torch.as_tensor(1.0 - train, **kw)
    yt = torch.as_tensor(np.asarray(y, np.float64), **kw)[None, :]
    dev = (test * (yt - mu) ** 2).sum(dim=1).double().cpu().numpy()
    share = np.bincount(folds, minlength=q + 1)[1:] / len(folds)
    return (dev.reshape(q, len(path)) * share[:, None]).sum(axis=0)
