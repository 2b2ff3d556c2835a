"""Parity of the PyTorch port's modules with the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``mendeliht_tpu_torch``.  On the CPU every port wrapper
takes its kernel's plain PyTorch version; the JAX side runs on the CPU XLA
backend (tests/conftest.py) and, for the Pallas score kernel, in interpret
mode, as tests/test_pallas.py runs it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mendeliht_tpu.genotype import snparray as jsnp
from mendeliht_tpu.ops import decode as jdecode
from mendeliht_tpu.ops import glm as jglm
from mendeliht_tpu.ops import pallas_kernels as jpk
from mendeliht_tpu.ops import projections as jproj
from mendeliht_tpu.ops.linalg import PackedOp as JPackedOp

from mendeliht_tpu_torch.genotype import snparray as tsnp
from mendeliht_tpu_torch.ops import decode as tdecode
from mendeliht_tpu_torch.ops import glm as tglm
from mendeliht_tpu_torch.ops import kernels as tkernels
from mendeliht_tpu_torch.ops import projections as tproj
from mendeliht_tpu_torch.ops.linalg import PackedOp as TPackedOp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# f32 sums of the same terms in another order: the bound tests/test_pallas.py
# holds the Pallas kernel to, relative to the output's column scale
TOL = 2e-5


def _codes(rng, n, p, missing=True):
    probs = [0.45, 0.05, 0.3, 0.2] if missing else [0.5, 0.0, 0.3, 0.2]
    return rng.choice(np.arange(4, dtype=np.uint8), size=(p, n), p=probs)


def _both_genotypes(codes_np):
    """(JAX, port) PackedGenotypes of the same SNP-major codes."""
    g = jsnp.PackedGenotypes.from_codes(codes_np, sample_major=False)
    t = tsnp.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")
    return g, t


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# (a) genotype container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,p,missing", [(300, 600, False), (130, 37, True),
                                         (1, 5, True)])
def test_from_codes_byte_identical(n, p, missing):
    rng = np.random.default_rng(11)
    codes = _codes(rng, n, p, missing).T                     # (n, p)
    g = jsnp.PackedGenotypes.from_codes(codes)
    t = tsnp.PackedGenotypes.from_codes(codes, device="cpu")
    assert t.words.dtype == torch.int32
    np.testing.assert_array_equal(t.words.numpy(), np.asarray(g.words))
    np.testing.assert_array_equal(t.mu.numpy(), np.asarray(g.mu))
    np.testing.assert_array_equal(t.inv_sd.numpy(), np.asarray(g.inv_sd))
    assert (t.n, t.p, t.has_missing) == (g.n, g.p, g.has_missing)
    np.testing.assert_array_equal(t.to_codes(), codes)
    np.testing.assert_array_equal(t.to_dense_standardized(),
                                  g.to_dense_standardized())


def test_from_packed_matches_jax():
    rng = np.random.default_rng(12)
    codes = _codes(rng, 200, 23)
    packed = jsnp.pack_codes(codes)
    mu = rng.random(23)
    inv_sd = rng.random(23)
    g = jsnp.PackedGenotypes.from_packed(packed, mu, inv_sd, n=200, p=23,
                                         has_missing=True)
    t = tsnp.PackedGenotypes.from_packed(packed, mu, inv_sd, n=200, p=23,
                                         has_missing=True, device="cpu")
    np.testing.assert_array_equal(t.words.numpy(), np.asarray(g.words))
    np.testing.assert_array_equal(t.mu.numpy(), np.asarray(g.mu))
    np.testing.assert_array_equal(t.packed_np(), packed)


# ---------------------------------------------------------------------------
# (b) the score pass: plain version vs Pallas (interpret) and XLA oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want_missing", [False, True])
@pytest.mark.parametrize("want_sq", [False, True])
@pytest.mark.parametrize("n,p,m,tp", [(200, 40, 1, 8), (130, 37, 5, 16)])
def test_xt_dots_words_parity(want_missing, want_sq, n, p, m, tp):
    rng = np.random.default_rng(13)
    codes = _codes(rng, n, p, missing=want_missing)
    packed = jsnp.pack_codes(codes)
    n4 = packed.shape[1]
    rhs = rng.standard_normal((4 * n4, m)).astype(np.float32)
    oracle = jdecode.xt_dots(jnp.asarray(packed), jnp.asarray(rhs),
                             want_missing=want_missing, want_sq=want_sq)
    pallas = jpk.xt_dots(jnp.asarray(packed), jnp.asarray(rhs),
                         want_missing=want_missing, want_sq=want_sq, tp=tp,
                         tw=128, interpret=True)
    words = torch.from_numpy(jsnp._bytes_to_words(packed))
    got = tkernels.xt_dots_words(words, torch.from_numpy(rhs),
                                 want_missing=want_missing, want_sq=want_sq,
                                 p=p)
    for k, wanted in enumerate((True, want_missing, want_sq)):
        if not wanted:
            assert got[k] is None
            continue
        assert got[k].shape == (p, m)
        assert _rel_err(got[k], oracle[k]) < TOL
        assert _rel_err(got[k], pallas[k]) < TOL


def test_xt_dots_words_keeps_quad_padding_without_p():
    """Without ``p`` the quad-padding SNP rows stay, as inert zeros, in the
    digit-plane score and in the f32 function."""
    rng = np.random.default_rng(14)
    codes = _codes(rng, 50, 6)
    words = torch.from_numpy(jsnp._bytes_to_words(jsnp.pack_codes(codes)))
    rhs = torch.from_numpy(rng.standard_normal((4 * words.shape[1], 2))
                           .astype(np.float32))
    for fn in (tdecode.xt_dots_words, tdecode.xt_dots):
        A, M, S = fn(words, rhs, want_missing=True, want_sq=True)
        assert A.shape == M.shape == S.shape == (8, 2)
        for out in (A, M, S):
            assert torch.all(out[6:] == 0)


def test_xt_dots_words_nan_column():
    """A NaN anywhere in an rhs column poisons that column and no other."""
    rng = np.random.default_rng(15)
    codes = _codes(rng, 100, 20)
    packed = jsnp.pack_codes(codes)
    n4 = packed.shape[1]
    rhs = rng.standard_normal((4 * n4, 3)).astype(np.float32)
    rhs[7, 1] = np.nan
    pallas = jpk.xt_dots(jnp.asarray(packed), jnp.asarray(rhs),
                         want_missing=True, want_sq=True, tp=8, tw=128,
                         interpret=True)
    words = torch.from_numpy(jsnp._bytes_to_words(packed))
    got = tkernels.xt_dots_words(words, torch.from_numpy(rhs),
                                 want_missing=True, want_sq=True, p=20)
    for out, ref in zip(got, pallas):
        arr = out.numpy()
        assert np.all(np.isnan(arr[:, 1]))
        assert np.all(np.isfinite(arr[:, [0, 2]]))
        assert _rel_err(arr[:, [0, 2]], np.asarray(ref)[:, [0, 2]]) < TOL


# ---------------------------------------------------------------------------
# (c) the operator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
def test_packed_op_xtr(missing):
    rng = np.random.default_rng(16)
    g, t = _both_genotypes(_codes(rng, 130, 45, missing))
    mask = np.zeros(g.n_pad, np.float32)
    mask[:g.n] = 1.0
    R = rng.standard_normal((2, g.n_pad)).astype(np.float32) * mask
    want = np.asarray(JPackedOp(g).xtr(jnp.asarray(R)))
    got = TPackedOp(t).xtr(torch.from_numpy(R)).numpy()
    assert got.shape == (2, 45)
    assert _rel_err(got, want) < TOL
    dense = R[:, :g.n] @ g.to_dense_standardized()
    assert _rel_err(got, dense) < TOL


@pytest.mark.parametrize("missing", [False, True])
def test_packed_op_forward_sel(missing):
    rng = np.random.default_rng(17)
    g, t = _both_genotypes(_codes(rng, 130, 45, missing))
    idx = np.stack([rng.choice(45, 6, replace=False) for _ in range(2)])
    coef = rng.standard_normal((2, 6)).astype(np.float32)
    valid = np.ones((2, 6), np.float32)
    valid[1, 4:] = 0
    want = np.asarray(JPackedOp(g).forward_sel(
        jnp.asarray(idx, jnp.int32), jnp.asarray(coef), jnp.asarray(valid)))
    got = TPackedOp(t).forward_sel(torch.from_numpy(idx),
                                   torch.from_numpy(coef),
                                   torch.from_numpy(valid)).numpy()
    assert got.shape == (2, g.n_pad)
    assert _rel_err(got, want) < TOL


def test_take_rows_bytes_matches_jax():
    rng = np.random.default_rng(18)
    g, t = _both_genotypes(_codes(rng, 64, 13))
    idx = np.array([[0, 5, 12], [3, 3, 7]])
    want = np.asarray(jdecode.take_rows_bytes(g.words, jnp.asarray(idx)))
    got = tdecode.take_rows_bytes(t.words, torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# (d) GLM Normal pieces and the projections
# ---------------------------------------------------------------------------

def _glm_inputs():
    rng = np.random.default_rng(19)
    y = rng.standard_normal((2, 64)).astype(np.float32)
    mu = rng.standard_normal((2, 64)).astype(np.float32)
    wt = (rng.random((2, 64)) < 0.8).astype(np.float32)
    return y, mu, wt


_GLM_CASES = {
    "linkinv": (lambda f, y, mu, wt: f.linkinv("identity", mu)),
    "mueta": (lambda f, y, mu, wt: f.mueta("identity", mu)),
    "glmvar": (lambda f, y, mu, wt: f.glmvar("normal", mu)),
    "devresid": (lambda f, y, mu, wt: f.devresid("normal", y, mu)),
    "loglik_obs": (lambda f, y, mu, wt: f.loglik_obs("normal", y, mu, wt,
                                                     0.5 + wt)),
    "deviance": (lambda f, y, mu, wt: f.deviance("normal", y, mu, wt)),
    "loglikelihood": (lambda f, y, mu, wt: f.loglikelihood(
        "normal", y, mu, wt, 64)),
    "score_residual": (lambda f, y, mu, wt: f.score_residual(
        "normal", "identity", y, mu, mu, wt)),
}


@pytest.mark.parametrize("name", sorted(_GLM_CASES))
def test_glm_normal_matches_jax(name):
    y, mu, wt = _glm_inputs()
    fn = _GLM_CASES[name]
    want = np.asarray(fn(jglm, jnp.asarray(y), jnp.asarray(mu),
                         jnp.asarray(wt)))
    got = fn(tglm, torch.from_numpy(y), torch.from_numpy(mu),
             torch.from_numpy(wt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_glm_batched_loglikelihood_matches_jax():
    y, mu, wt = _glm_inputs()
    want = np.asarray(jglm.loglikelihood("normal", jnp.asarray(y),
                                         jnp.asarray(mu), jnp.asarray(wt),
                                         64, axis=1))
    got = tglm.loglikelihood("normal", torch.from_numpy(y),
                             torch.from_numpy(mu), torch.from_numpy(wt), 64,
                             dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_glm_names_and_unported_families():
    """The names, and the families that raised before they were ported:
    now equal to the JAX package's (tests/test_torch_glm.py holds every
    family and link), and a name neither package knows raises ValueError
    in both."""
    assert tglm.dist_name(tglm.Normal()) == jglm.dist_name(jglm.Normal())
    assert tglm.dist_name("Normal") == "normal"
    assert tglm.link_name(tglm.IdentityLink()) == "identity"
    assert tglm._CANONICAL == jglm._CANONICAL
    x = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    np.testing.assert_allclose(tglm.linkinv("logit", torch.from_numpy(x)),
                               jglm.linkinv("logit", jnp.asarray(x)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tglm.glmvar("poisson", torch.from_numpy(np.exp(x))),
        jglm.glmvar("poisson", jnp.asarray(np.exp(x))), rtol=1e-6)
    for pkg, arr in ((tglm, torch.zeros(3)), (jglm, jnp.zeros(3))):
        with pytest.raises(ValueError, match="unknown link"):
            pkg.linkinv("cauchit", arr)
        with pytest.raises(ValueError, match="unknown distribution"):
            pkg.glmvar("tweedie", arr)


def _distinct_bc(rng, B, p, q):
    """b, c with distinct magnitudes (torch.topk is not index-stable on
    ties, ROADMAP Queue 3)."""
    mags = rng.permutation(np.arange(1, B * (p + q) + 1)).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], size=mags.shape).astype(np.float32)
    full = (mags * signs / 10.0).reshape(B, p + q)
    return full[:, :p].copy(), full[:, p:].copy()


@pytest.mark.parametrize("zkeep", [[True], [False, True, False]])
def test_project_topk_joint_matches_jax(zkeep):
    rng = np.random.default_rng(20)
    q = len(zkeep)
    b, c = _distinct_bc(rng, 3, 50, q)
    zk = np.array(zkeep)
    kk = np.array([4, 6, 2]) + zk.sum()
    S = 6 + q
    want = jproj.project_topk_joint(jnp.asarray(b), jnp.asarray(c),
                                    jnp.asarray(kk), jnp.asarray(zk), S)
    got = tproj.project_topk_joint(torch.from_numpy(b), torch.from_numpy(c),
                                   torch.from_numpy(kk), torch.from_numpy(zk),
                                   S)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


def test_select_support_matches_jax():
    rng = np.random.default_rng(21)
    b, c = _distinct_bc(rng, 2, 40, 2)
    b[:, ::3] = 0.0
    zk = np.array([True, False])
    want = jproj.select_support(jnp.asarray(b), jnp.asarray(c),
                                jnp.asarray(zk), 9)
    got = tproj.select_support(torch.from_numpy(b), torch.from_numpy(c),
                               torch.from_numpy(zk), 9)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
