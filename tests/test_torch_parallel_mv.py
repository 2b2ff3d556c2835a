"""The port's sharded multivariate solver against the JAX package, the twin
of tests/test_parallel_mv.py.

One world of 4 gloo ranks on the CPU (``tests/torch_multihost_worker.py``,
started once for the module) forms the (task, snp) meshes (2, 2), (1, 4)
and (4, 1) and computes every case; the JAX package runs single-device in
this process meanwhile.  As the port's mv loop is stepped from the host,
the oracle is the JAX package's host-stepped mv solver
(``mv_streamed._iteration_mv_host`` / ``run_mv_iht_host`` /
``cv_mv_host``; tests/test_torch_mv.py holds the port's single-device mv
solver to it), each from its own initial state, which the ranks shard.
The response is the JAX test's (seed 91: 3 traits, 6 causal (trait, SNP)
entries of distinct magnitudes, so no top-k ties).

Tolerances are the JAX tests': one iteration, B within rtol 1e-5 / atol
1e-6 and logl within rtol 1e-5 of the port's single-device iteration and
within 1e-5 of its terms' scale (n r / 2) of the JAX package's; the full
solve the same support, B within
rtol 1e-4 / atol 1e-5, best logl within rtol 1e-5; the ragged p (603 over
4 shards, padded to 608 inert rows, a causal SNP in the last column) the
unpadded solve's B within rtol 1e-4 / atol 1e-5, no pad column selected;
the cv's mse within rtol 1e-4 / atol 1e-4; the port's init_mv_state on the
sharded operator the JAX package's initial support, df within 1e-5 of
max|df|.  The multivariate ``fit_iht`` through the sharded operator against
the JAX package's public one: the same (trait, SNP) support, B and C within
``tests/test_torch_mv.py::MV_SPREAD`` (5e-4) of max|B|, logl within 1e-5
relative, iterations within one.  The ranks' results agree bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import mv as jmv
from mendeliht_tpu.models import mv_streamed as jmvs
from mendeliht_tpu.parallel.mesh import pad_geno_rows as jpad

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import mv as tmv

from torch_multihost_worker import World

MESHES = [(2, 2), (1, 4), (4, 1)]
TAGS = [f"{a}x{b}" for a, b in MESHES]
MV_SPREAD = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_problem(rng, n=128, p=512, r=3, k=6, last=False):
    """The JAX test's problem: codes and Y (r, n) over k causal (trait,
    SNP) entries (the last SNP among them where ``last``)."""
    codes = rng.choice([0, 2, 3], size=(n, p),
                       p=[0.4, 0.35, 0.25]).astype(np.uint8)
    Xd = m.PackedGenotypes.from_codes(codes).to_dense_standardized()
    Btrue = np.zeros((r, p))
    hot = (np.concatenate([rng.choice(p - 1, k - 1, replace=False), [p - 1]])
           if last else rng.choice(p, k, replace=False))
    for j in hot:
        Btrue[rng.integers(0, r), j] = rng.standard_normal() * 2
    return codes, Btrue @ Xd.T + 0.1 * rng.standard_normal((r, n))


def _np_state(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _setup(codes, Y, k, T, max_iter, pad=False):
    x = m.PackedGenotypes.from_codes(codes)
    xs = jpad(x, 4) if pad else x

    def init(xx):
        op, data, cfg = jmv.build_mv(Y, xx, k=k, max_iter=max_iter)
        cv = jnp.broadcast_to(data.sample_mask[None, :], (T, op.n_pad))
        return op, data, cfg, jmv.init_mv_state(
            op, data, cfg, jnp.full((T,), k, jnp.int32), cv)
    args = init(x)
    return args, _np_state(init(xs)[3] if pad else args[3])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp, ref = {"meshes": np.asarray(MESHES)}, {}
    codes, Y = _make_problem(np.random.default_rng(91))
    setups = {"main": _setup(codes, Y, 6, 4, 25)}
    rc, rY = _make_problem(np.random.default_rng(93), n=96, p=603, r=2, k=5,
                           last=True)
    setups["ragged"] = _setup(rc, rY, 5, 2, 20, pad=True)
    inp.update({"main/codes": codes, "main/Y": Y, "ragged/codes": rc,
                "ragged/Y": rY, "ragged/k": 5})
    for case, (_, st_np) in setups.items():
        inp.update({f"{case}/st0/{k}": v for k, v in st_np.items()})
    rng = np.random.default_rng(95)
    folds = rng.integers(1, 3, size=128)
    ks = np.asarray([2, 4, 2, 4], np.int64)
    op = setups["main"][0][0]
    train = np.zeros((4, op.n_pad), np.float32)
    test = np.zeros_like(train)
    for i in range(4):
        train[i, :128] = folds != 1 + i // 2
        test[i, :128] = folds == 1 + i // 2
    inp.update({"cv/ks": ks, "cv/train": train, "cv/test": test})

    w = World("parallel_mv", 4, inp, tmp_path_factory.mktemp("parallel_mv"))

    op, data, cfg, st0 = setups["main"][0]
    ref["iter"] = jmvs._iteration_mv_host(op, data, cfg, st0)
    top, tdata, tcfg = tmv.build_mv(Y, mt.PackedGenotypes.from_codes(
        codes, device="cpu"), k=6, max_iter=25)
    ref["iter_port"] = tmv._iteration_mv(top, tdata, tcfg,
                                         tmv.MIHTState.from_numpy(
                                             setups["main"][1], "cpu"))
    for case, (args, st_np) in setups.items():
        ref[case] = (st_np, jmvs.run_mv_iht_host(*args))
    ref["cv"] = jmvs.cv_mv_host(op, data, cfg, jnp.asarray(ks),
                                jnp.asarray(train), jnp.asarray(test))
    ref["fit"] = m.fit_iht(Y, m.PackedGenotypes.from_codes(codes), k=6,
                           max_iter=25, verbose=False)
    return w.results(), ref


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_mv_iteration_matches(world, tag):
    """One iteration: B as the JAX test holds it; the loglikelihood
    n/2 logdet(Gamma) - 1/2 tr(Gamma R R') is a difference of terms of
    about n r / 2 = 192, each in f32, so against the JAX package it is held
    within 1e-5 of that scale, and within rtol 1e-5 of the port's
    single-device iteration (the same arithmetic but the ranks' sums)."""
    res, ref = world
    out, want = res[0], ref["iter"]
    _close(out[f"iter_{tag}/B"], want.B, 1e-5, 1e-6)
    _close(out[f"iter_{tag}/logl"], want.logl, 0, 1e-5 * 128 * 3 / 2)
    _close(out[f"iter_{tag}/logl"], ref["iter_port"].logl.numpy(), 1e-5)
    np.testing.assert_array_equal(out[f"iter_{tag}/active"],
                                  np.asarray(want.active))


def test_sharded_mv_full_solve_matches(world):
    res, ref = world
    out, want = res[0], ref["main"][1]
    _close(out["main/best_logl"], want.best_logl, 1e-5)
    np.testing.assert_array_equal(out["main/B"] != 0, np.asarray(want.B) != 0)
    _close(out["main/B"], want.B, 1e-4, 1e-5)


def test_sharded_mv_ragged_p(world):
    res, ref = world
    out, want = res[0], ref["ragged"][1]
    _close(out["ragged/B"][:, :, :603], want.B, 1e-4, 1e-5)
    assert not np.any(out["ragged/B"][:, :, 603:])   # pads never selected
    _close(out["ragged/best_logl"], want.best_logl, 1e-5)


@pytest.mark.parametrize("case", ["main", "ragged"])
def test_init_mv_state_on_sharded_operator(world, case):
    res, ref = world
    out, want = res[0], ref[case][0]
    np.testing.assert_array_equal(out[f"{case}/init/sel_valid"],
                                  want["sel_valid"])
    np.testing.assert_array_equal(out[f"{case}/init/df"] != 0,
                                  want["df"] != 0)
    scale = np.abs(want["df"]).max()
    for name in ("df", "df2"):
        _close(out[f"{case}/init/{name}"], want[name], 0, 1e-5 * scale)
    _close(out[f"{case}/init/C"], want["C"], 1e-5, 1e-6)


def test_sharded_mv_cv_matches(world):
    """One mv cv batch (4 tasks over the 2 task rows) == the JAX mses."""
    res, ref = world
    _close(res[0]["cv/mse"], ref["cv"], 1e-4, 1e-4)


def test_mv_fit_iht_takes_sharded_operator(world):
    res, ref = world
    out, want = res[0], ref["fit"]
    np.testing.assert_array_equal(out["fit_entry/beta"] != 0, want.beta != 0)
    scale = np.abs(want.beta).max()
    _close(out["fit_entry/beta"], want.beta, 0, MV_SPREAD * scale)
    _close(out["fit_entry/c"], want.c, 0, MV_SPREAD * scale)
    _close(out["fit_entry/logl"], want.logl, 1e-5)
    assert abs(int(out["fit_entry/iter"]) - want.iter) <= 1


def test_ranks_agree(world):
    res = world[0]
    for key, v in res[0].items():
        for other in res[1:]:
            np.testing.assert_array_equal(other[key], v, err_msg=key)
