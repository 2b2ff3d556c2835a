"""The port's SNP-sharded solver (``mendeliht_tpu_torch.parallel``) against
the JAX package, the twin of tests/test_parallel.py.

The port runs in one world of 4 gloo ranks on the CPU (one process a rank,
one torch thread each, ``tests/torch_multihost_worker.py``), started once
for the module: the ranks form the (task, snp) meshes (2, 2), (1, 4) and
(4, 1) in turn and compute every case, and each test reads its case.  The
JAX package runs in this process meanwhile, single-device: its sharded
solver equals its single-device one (tests/test_parallel.py), so that is
the oracle, its one iteration (``univariate._iteration``) and, as the
port's solver is stepped from the host, its host-stepped solve
(``streamed.run_iht_host``), each from its own initial state, which the
ranks shard.  Inputs are the JAX tests' problems, made from their seeds
with numpy; their top-k has no exact ties.

Tolerances are the JAX tests': one iteration, b within rtol 1e-5 / atol
1e-6 and logl within rtol 1e-5 (the sharded forward product sums over the
ranks in another f32 order); full solves, the same support, b within rtol
1e-4 / atol 1e-5, best logl within rtol 1e-5; the edge cases and the group
projections as their JAX tests hold them (b within rtol 1e-5 / atol 1e-6);
the operator's products within rtol 2e-5 / atol 1e-4 of the single-device
``PackedOp``; the port's init_state on the sharded operator, the JAX
package's initial support, df and df2 within 1e-5 of max|df|.  The
vector-k group fit ends on a loglikelihood plateau, where f32 ties decide
the backtracks (ROADMAP Queue 3): at its 10th iteration the JAX package
backtracks 3 times and the port, sharded or not, once.  So it is held to
the port's single-device solve at those tolerances, and to the JAX
package's at the plateau spread of tests/test_torch_families.py (the same
support, betas within 2e-3 of max|beta|, logl within 1e-4).  The four
JAX edge cases use 4 ranks where the JAX tests use 8 devices:
``support_exceeds_shard_rows`` takes p = 60 (16 SNPs a shard below S =
32), ``group_spanning_shards`` 3 groups of 256 SNPs over shards of 192.
The entry points ``fit_iht`` and ``cv_iht`` take the sharded operator
(against the JAX package's public ones: support, beta rtol 1e-4, mse
rtol 1e-4).  The ranks' results agree bit for bit.

Checkpoints of the sharded cv (the ranks' ``_checkpoint_cases``, in
directories under the test's tmp dir): within the port bit for bit (a
second call on a finished run's directory, F6's problem; a cv stopped by
max_iter = 5 and resumed against the uninterrupted one; the state a
segmented solve held against its file and the sharded restore); across
meshes and devices (a (2, 2) checkpoint resumed on (1, 4) and on one
device, a single-device one on (2, 2)) mse within rtol 1e-4 and the same
best k, as against the JAX package's cv stopped and resumed alike; a
checkpoint of other shapes raises before any step; the progress and
checkpoint lines count the whole grid.
"""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models import mv as jmv
from mendeliht_tpu.models.fit import build_fit as jbuild_fit
from mendeliht_tpu.models.initialize import init_state as jinit_state
from mendeliht_tpu.models.univariate import _iteration as jiteration
from mendeliht_tpu.models.streamed import run_iht_host as jrun_iht
from mendeliht_tpu.parallel.mesh import pad_geno_rows as jpad

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models.fit import build_fit as tbuild_fit
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.models.univariate import run_iht as trun_iht
from mendeliht_tpu_torch.ops.linalg import PackedOp
from mendeliht_tpu_torch.parallel import pad_geno_rows
from mendeliht_tpu_torch.utils import checkpoint as ckpt

from torch_multihost_worker import World

MESHES = [(2, 2), (1, 4), (4, 1)]
TAGS = [f"{a}x{b}" for a, b in MESHES]
B = 4
# the checkpointed cvs' budget (their 6 (fold, k) tasks all converge
# within it)
CK_MAX_ITER = 25
# a fit that ends on a loglikelihood plateau, against the JAX package:
# betas within this share of max|beta| (tests/test_torch_families.py)
PLATEAU_SPREAD = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module (its rank processes take
    one each), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(rng, n, p, probs=(0.4, 0.35, 0.25)):
    return rng.choice([0, 2, 3], size=(n, p), p=list(probs)).astype(np.uint8)


def _problem(seed, n, p, k, hot=None, scale=2.0, noise=0.1, shift=0.0):
    """The JAX tests' problems: codes, y = X b + noise over k causal
    SNPs (``hot`` fixes them), effects N(shift, scale^2)."""
    rng = np.random.default_rng(seed)
    codes = _codes(rng, n, p)
    Xd = m.PackedGenotypes.from_codes(codes).to_dense_standardized()
    btrue = np.zeros(p)
    if hot is None:
        hot = rng.choice(p, k, replace=False)
    btrue[hot] = rng.standard_normal(len(hot)) * scale + shift
    return codes, Xd @ btrue + noise * rng.standard_normal(n)


def _group_problem(seed, n=128, p=512, n_groups=8):
    rng = np.random.default_rng(seed)
    codes = _codes(rng, n, p)
    Xd = m.PackedGenotypes.from_codes(codes).to_dense_standardized()
    group = np.repeat(np.arange(1, n_groups + 1), p // n_groups)
    btrue = np.zeros(p)
    for g in (2, min(5, n_groups)):
        cols = rng.choice(np.flatnonzero(group == g), 3, replace=False)
        btrue[cols] = rng.standard_normal(3) * 2
    return codes, Xd @ btrue + 0.1 * rng.standard_normal(n), group


def _jax_setup(codes, y, k, pad=False, max_iter=25, **kw):
    """The JAX package's (op, data, cfg, initial state) of a batch of B
    equal fits, and that initial state as numpy on the genotypes padded to
    4 shards where ``pad``, as the ranks shard them."""
    def setup(x):
        op, data, cfg, k_scalar = jbuild_fit(y, x, None, k=k,
                                             max_iter=max_iter, **kw)
        if cfg.group_k_is_vector:
            ks = jnp.zeros((B,), jnp.int32)
        elif cfg.use_group:
            ks = jnp.full((B,), int(k), jnp.int32)
        else:
            ks = jnp.full((B,), k_scalar, jnp.int32)
        cv_wts = jnp.broadcast_to(data.sample_mask[None, :], (B, op.n_pad))
        return op, data, cfg, jinit_state(op, data, cfg, ks, cv_wts)

    x = m.PackedGenotypes.from_codes(codes)
    op, data, cfg, st = setup(x)
    return (op, data, cfg, st), _np_state(setup(jpad(x, 4))[3] if pad
                                          else st)


def _np_state(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(every rank's results, the JAX and single-device oracles)."""
    inp, ref = {"meshes": np.asarray(MESHES)}, {}
    codes, y = _problem(42, 128, 512, 6)
    x = m.PackedGenotypes.from_codes(codes)
    op, data, cfg, _ = jbuild_fit(y, x, None, k=6, max_iter=30)
    st0 = jinit_state(op, data, cfg, jnp.full((B,), 6, jnp.int32),
                      jnp.broadcast_to(data.sample_mask[None, :],
                                       (B, op.n_pad)))
    inp.update({"main/codes": codes, "main/y": y, "main/k": 6})
    rng = np.random.default_rng(3)
    ops_in = dict(
        R=rng.standard_normal((B, op.n_pad)).astype(np.float32),
        idx=rng.integers(0, 512, (B, 6)).astype(np.int64),
        coef=rng.standard_normal((B, 6)).astype(np.float32),
        valid=(rng.random((B, 6)) > 0.3).astype(np.float32),
        W=rng.random((B, op.n_pad)).astype(np.float32))
    ops_in["WY"] = ops_in["W"] * rng.standard_normal(op.n_pad).astype(
        np.float32)
    inp.update({f"ops/{k}": v for k, v in ops_in.items()})

    rng = np.random.default_rng(11)             # ragged p = 603, last SNP on
    hot = np.concatenate([rng.choice(602, 4, replace=False), [602]])
    edge = {"ragged": (_problem(11, 96, 603, 5, hot=hot), 5),
            "exceed": (_problem(13, 160, 60, 10, scale=1.0), 31),
            "one_shard": (_problem(17, 128, 512, 6, hot=np.arange(6),
                                   noise=0.05, shift=1.0), 6)}
    for case, ((c, yy), kk) in edge.items():
        inp.update({f"{case}/codes": c, f"{case}/y": yy, f"{case}/k": kk})
    groups = {"group_scalar": (_group_problem(23), 3),
              "group_vector": (_group_problem(29), [1, 1, 3, 1, 1, 3, 1, 1]),
              "group_span": (_group_problem(31, p=768, n_groups=3), 3)}
    for case, ((c, yy, g), kk) in groups.items():
        inp.update({f"{case}/codes": c, f"{case}/y": yy, f"{case}/k": kk,
                    f"{case}/group": g})
    folds = np.random.default_rng(5).integers(1, 3, size=128)
    inp.update({"cv/path": [2, 4, 6], "cv/q": 2, "cv/folds": folds})

    setups = {"main": ((op, data, cfg, st0), _np_state(st0))}
    for case, ((c, yy), kk) in edge.items():
        setups[case] = _jax_setup(c, yy, kk, pad=case != "one_shard")
    for case, ((c, yy, g), kk) in groups.items():
        setups[case] = _jax_setup(c, yy, kk, J=2, group=g)
    for case, (_, st_np) in setups.items():
        inp.update({f"{case}/st0/{k}": v for k, v in st_np.items()})

    # checkpoints: F6's problem, and the cv problem's under ck_dir
    f6_codes, f6_y = _problem(5, 200, 512, 5)
    inp.update({"f6/codes": f6_codes, "f6/y": f6_y,
                "f6/folds": np.random.default_rng(5).integers(1, 3, size=200),
                "ckpt/max_iter": CK_MAX_ITER})
    ck_dir = tmp_path_factory.mktemp("parallel_ckpt")
    inp["ckpt/dir"] = str(ck_dir)
    ckw = dict(path=[2, 4, 6], q=2, folds=folds, verbose=False)
    # the single-device checkpoint the ranks resume on the (2, 2) mesh
    mt.cv_iht(y, mt.PackedGenotypes.from_codes(codes, device="cpu"),
              checkpoint_dir=str(ck_dir / "from_single"), checkpoint_every=2,
              max_iter=5, **ckw)

    w = World("parallel", 4, inp, tmp_path_factory.mktemp("parallel"))

    jd = str(tmp_path_factory.mktemp("parallel_ckpt_jax"))
    m.cv_iht(y, x, checkpoint_dir=jd, checkpoint_every=2, max_iter=5, **ckw)
    ref["ckpt"] = dict(codes=codes, y=y, folds=folds, dir=ck_dir,
                       jax_resumed=m.cv_iht(y, x, checkpoint_dir=jd,
                                            checkpoint_every=2,
                                            max_iter=CK_MAX_ITER, **ckw))

    # the oracles, while the ranks run: (ranks' initial state, solve)
    ref["iter"] = jiteration(op, data, cfg, st0)
    for case, (args, st_np) in setups.items():
        ref[case] = (st_np, jrun_iht(*args))
    ref["fit"] = m.fit_iht(y, x, k=6, max_iter=30, verbose=False)
    ref["cv"] = m.cv_iht(y, x, path=[2, 4, 6], q=2, folds=folds,
                         verbose=False)
    ref["dryrun"] = _jax_dryrun()
    (c, yy, g), kk = groups["group_vector"]
    tx = mt.PackedGenotypes.from_codes(c, device="cpu")
    top, tdata, tcfg, _ = tbuild_fit(yy, tx, None, k=kk, J=2, group=g,
                                     max_iter=25)
    ref["group_vector_port"] = trun_iht(top, tdata, tcfg, IHTState.from_numpy(
        setups["group_vector"][1], "cpu"))
    t = mt.PackedGenotypes.from_codes(codes, device="cpu")
    top = PackedOp(t)
    tt = {k: torch.from_numpy(v) for k, v in ops_in.items()}
    ref["ops"] = dict(
        xtr=top.xtr(tt["R"]),
        forward_sel=top.forward_sel(tt["idx"], tt["coef"], tt["valid"]),
        gather_cols=top.gather_cols(tt["idx"], tt["valid"]),
        **dict(zip(("Sx", "Sxx", "Sxy"), top.col_moments(tt["W"],
                                                         tt["WY"]))))
    return w.results(), ref


def _jax_dryrun():
    """The JAX package's two single-device iterations of its dry run's
    problems (``__graft_entry__._tiny_problem`` at B = 4, and the 3-trait
    one): whole loglikelihoods after each."""
    from __graft_entry__ import _tiny_problem
    op, data, cfg, st = _tiny_problem(n=96, p=512, B=B)
    logl = []
    for _ in range(2):
        st = jiteration(op, data, cfg, st)
        logl.append(np.asarray(st.logl))
    rng = np.random.default_rng(7)
    n, p, r, kmv = 96, 512, 3, 5
    x = m.PackedGenotypes.from_codes(_codes(rng, n, p, (0.35, 0.4, 0.25)))
    Xd = x.to_dense_standardized()
    Btrue = np.zeros((r, p))
    for j in rng.choice(p, kmv, replace=False):
        Btrue[rng.integers(0, r), j] = rng.standard_normal()
    Y = Btrue @ Xd.T + 0.1 * rng.standard_normal((r, n))
    mop, mdata, mcfg = jmv.build_mv(Y, x, k=kmv, max_iter=20)
    mst = jmv.init_mv_state(mop, mdata, mcfg, jnp.full((B,), kmv, jnp.int32),
                            jnp.broadcast_to(mdata.sample_mask[None, :],
                                             (B, mop.n_pad)))
    mv_logl = []
    for _ in range(2):
        mst = jmv._iteration_mv(mop, mdata, mcfg, mst)
        mv_logl.append(np.asarray(mst.logl))
    return np.asarray(logl), np.asarray(mv_logl)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_iteration_matches(world, tag):
    res, ref = world
    out, want = res[0], ref["iter"]
    _close(out[f"iter_{tag}/b"], want.b, 1e-5, 1e-6)
    _close(out[f"iter_{tag}/logl"], want.logl, 1e-5)
    np.testing.assert_array_equal(out[f"iter_{tag}/active"],
                                  np.asarray(want.active))


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_full_solve_matches(world, tag):
    res, ref = world
    out, want = res[0], ref["main"][1]
    _close(out[f"solve_{tag}/best_logl"], want.best_logl, 1e-5)
    np.testing.assert_array_equal(out[f"solve_{tag}/b"] != 0,
                                  np.asarray(want.b) != 0)
    _close(out[f"solve_{tag}/b"], want.b, 1e-4, 1e-5)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("name", ["xtr", "forward_sel", "Sx", "Sxx", "Sxy",
                                  "gather_cols"])
def test_sharded_operator_matches(world, tag, name):
    """Each product of the sharded operator, every task's rows whole,
    against the single-device PackedOp on the same inputs."""
    res, ref = world
    _close(res[0][f"ops_{tag}/{name}"], ref["ops"][name].numpy(), 2e-5, 1e-4)


INIT_CASES = ["solve_2x2", "solve_1x4", "solve_4x1", "ragged", "exceed",
              "one_shard", "group_scalar", "group_scalar_1x4", "group_vector",
              "group_span"]


@pytest.mark.parametrize("case", INIT_CASES)
def test_init_state_on_sharded_operator(world, case):
    """The port's init_state through the sharded operator (its (B, p)
    arrays gathered whole) against the JAX package's initial state: the
    same support, df within 1e-5 of its scale, c and the linear predictors
    within rtol 1e-5."""
    res, ref = world
    src = {"solve_2x2": "main", "solve_1x4": "main", "solve_4x1": "main",
           "group_scalar_1x4": "group_scalar"}.get(case, case)
    out, want = res[0], ref[src][0]
    got = {k[len(case) + 6:]: v for k, v in out.items()
           if k.startswith(case + "/init/")}
    np.testing.assert_array_equal(got["sel_valid"], want["sel_valid"])
    np.testing.assert_array_equal(np.where(got["sel_valid"], got["sel_idx"],
                                           0),
                                  np.where(want["sel_valid"],
                                           want["sel_idx"], 0))
    np.testing.assert_array_equal(got["df"] != 0, want["df"] != 0)
    scale = np.abs(want["df"]).max()
    for name in ("df", "df2"):
        _close(got[name], want[name], 0, 1e-5 * scale)
    for name in ("c", "zc", "mu"):
        _close(got[name], want[name], 1e-5, 1e-6)


def _edge(world, case, p_true):
    res, ref = world
    out, want = res[0], ref[case][1]
    _close(out[f"{case}/b"][:, :p_true], want.b, 1e-5, 1e-6)
    assert not np.any(out[f"{case}/b"][:, p_true:])   # pads never selected
    _close(out[f"{case}/best_logl"], want.best_logl, 1e-5)
    return out[f"{case}/b"]


def test_ragged_shard_boundary(world):
    """p = 603 over 4 shards, padded to 608 with inert rows, a causal SNP
    in the last column: the sharded solve equals the unpadded one."""
    assert pad_geno_rows(mt.PackedGenotypes.from_codes(
        np.zeros((4, 603), np.uint8), device="cpu"), 4).p == 608
    _edge(world, "ragged", 603)


def test_support_exceeds_shard_rows(world):
    """S = 32 support slots > 16 rows a shard (p = 60 padded to 64)."""
    _edge(world, "exceed", 60)


def test_all_selected_on_one_shard(world):
    """Every causal SNP on one shard: the sums over the ranks must not
    count a column twice, and the other ranks' zeros must not disturb the
    forward product."""
    b = _edge(world, "one_shard", 512)
    assert set(np.flatnonzero(b[0])) <= set(range(256))   # shard (., 0)


@pytest.mark.parametrize("case", ["group_scalar_2x2", "group_scalar_1x4",
                                  "group_vector", "group_span"])
def test_sharded_group_projection_matches(world, case):
    """Group IHT on the mesh (scalar and vector k; groups that span
    shards) equals the single-device JAX solve; at most J = 2 groups."""
    res, ref = world
    src = "group_scalar" if case.startswith("group_scalar") else case
    out, want = res[0], ref[src][1]
    case = src if case == "group_scalar_2x2" else case
    if case == "group_vector":
        # ends on a loglikelihood plateau, where f32 ties decide the
        # backtracks: the port's single-device solve and the JAX
        # package's backtrack apart at iteration 10 (module docstring)
        single = ref["group_vector_port"]
        _close(out[f"{case}/b"], single.b.numpy(), 1e-5, 1e-6)
        _close(out[f"{case}/best_logl"], single.best_logl.numpy(), 1e-5)
        np.testing.assert_array_equal(out[f"{case}/b"] != 0,
                                      np.asarray(want.b) != 0)
        scale = np.abs(np.asarray(want.b)).max()
        _close(out[f"{case}/b"], want.b, 0, PLATEAU_SPREAD * scale)
        _close(out[f"{case}/best_logl"], want.best_logl, 1e-4)
    else:
        _close(out[f"{case}/b"], want.b, 1e-5, 1e-6)
        _close(out[f"{case}/best_logl"], want.best_logl, 1e-5)
    group = _group_problem(31, p=768, n_groups=3)[2] if case == \
        "group_span" else _group_problem(23)[2]
    assert len(np.unique(group[np.flatnonzero(out[f"{case}/b"][0])])) <= 2


def test_fit_iht_takes_sharded_operator(world):
    """fit_iht through ShardedPackedOp (make_operator passes it on) on the
    (1, 4) mesh: the JAX fit's support, beta and logl."""
    res, ref = world
    out, want = res[0], ref["fit"]
    np.testing.assert_array_equal(np.flatnonzero(out["fit_entry/beta"]),
                                  np.flatnonzero(want.beta))
    _close(out["fit_entry/beta"], want.beta, 1e-4, 1e-5)
    _close(out["fit_entry/logl"], want.logl, 1e-5)
    assert abs(int(out["fit_entry/iter"]) - want.iter) <= 1


def test_cv_iht_takes_sharded_operator(world):
    """cv_iht through ShardedPackedOp on the (2, 2) mesh, its 6 (fold, k)
    tasks split over the task rows: the JAX cv's mse."""
    res, ref = world
    _close(res[0]["cv_entry/mse"], ref["cv"], 1e-4)


# -- checkpoint and resume of the sharded cv ---------------------------------

def _agree(got, want):
    """mse within rtol 1e-4 of ``want`` and the same best k."""
    _close(got, want, 1e-4)
    assert np.argmin(got) == np.argmin(want)


def test_sharded_cv_second_call_on_its_directory(world):
    """F6's problem (n = 200, p = 512, 5 causal SNPs): a checkpointed cv
    called again on its own directory (which holds the finished run's
    last step) returns the same mse bit for bit, and both equal the run
    without checkpoints (the ranks once resumed from another rank's SNP
    columns and returned a wrong mse).  Held within the port: its task
    (fold 2, k 2) stops at iteration 7 on one device and 8 on the meshes
    (its convergence test at iteration 7 lies within f32 rounding of the
    tolerance), which moves its mse 2.3e-4 from the JAX package's."""
    out = world[0][0]
    np.testing.assert_array_equal(out["f6/first"], out["f6/plain"])
    np.testing.assert_array_equal(out["f6/second"], out["f6/first"])


def test_sharded_cv_resumes_bit_for_bit(world):
    """A cv stopped by max_iter = 5 (its last step 4) and called again
    with the full budget resumes and equals the uninterrupted sharded cv
    bit for bit, and the JAX package's cv stopped and resumed alike."""
    out, ref = world[0][0], world[1]["ckpt"]
    assert "resuming from checkpoint step 4" in str(out["ckpt/stdout"])
    np.testing.assert_array_equal(out["ckpt/resumed"], out["ckpt/plain"])
    _agree(out["ckpt/resumed"], ref["jax_resumed"])


def test_sharded_checkpoint_is_one_whole_state_file(world):
    """Each step is one file of the whole state (b (B, p_pad)), written by
    rank 0 alone, the newest two kept; the single-device reader restores
    it, equal bit for bit to the state the solve held whole, as the
    sharded restore gives it back."""
    res, ref = world[0], world[1]["ckpt"]
    for name in ("twice", "stop", "state", "from_single"):
        d = str(ref["dir"] / name)
        names = sorted(os.listdir(d))
        assert 1 <= len(names) <= 2
        assert all(re.fullmatch(r"step_\d+", f)
                   and os.path.isfile(os.path.join(d, f)) for f in names)
    out = res[0]
    held = {k.split("/", 1)[1]: v for k, v in out.items()
            if k.startswith("ckpt_state/") and k != "ckpt_state/wrote"}
    like = IHTState.from_numpy(dict(held, iteration=0), "cpu")
    back, step = ckpt.restore_state(str(ref["dir"] / "state"), like)
    assert step == back.iteration == 4 == int(out["ckpt_back/step"])
    assert int(out["ckpt_back/iteration"]) == 4
    assert back.b.shape == (6, 512)
    for name, v in held.items():
        np.testing.assert_array_equal(getattr(back, name).numpy(), v,
                                      err_msg=name)
        np.testing.assert_array_equal(out[f"ckpt_back/{name}"], v,
                                      err_msg=name)
    for r, o in enumerate(res):
        assert len(o["ckpt_state/wrote"]) == 2
        assert o["ckpt_state/wrote"].tolist() == [r == 0] * 2


@pytest.mark.parametrize("where", ["1x4", "one_device", "from_one_device"])
def test_checkpoint_resumes_on_another_grid(world, where, capsys):
    """The (2, 2) mesh's checkpoint at step 4 resumes on the (1, 4) mesh
    and on one CPU device (in this process), and a single-device
    checkpoint resumes on the (2, 2) mesh (p = 512 pads to 512 on each):
    the uninterrupted sharded cv's mse within rtol 1e-4, the same best
    k."""
    out, ref = world[0][0], world[1]["ckpt"]
    if where == "one_device":
        got = mt.cv_iht(ref["y"], mt.PackedGenotypes.from_codes(
            ref["codes"], device="cpu"), path=[2, 4, 6], q=2,
            folds=ref["folds"], max_iter=CK_MAX_ITER,
            checkpoint_dir=str(ref["dir"] / "stop_single"),
            checkpoint_every=2)
        assert "resuming from checkpoint step 4" in capsys.readouterr().out
    else:
        got = out[{"1x4": "ckpt/resumed_1x4",
                   "from_one_device": "ckpt/from_single"}[where]]
    _agree(got, out["ckpt/plain"])


def test_checkpoint_of_other_shapes_raises(world):
    """A cv of 4 tasks on a directory of a 6-task cv raises ValueError on
    every rank, naming both whole shapes, before any step (no step
    saved)."""
    for out in world[0]:
        msg = str(out["ckpt/mismatch"])
        assert "'b'" in msg and "(6, 512)" in msg and "(4, 512)" in msg
        assert out["ckpt/mismatch_steps"].tolist() == [2, 4]


def test_sharded_cv_progress_counts_whole_grid(world):
    """Every rank's progress and checkpoint lines count the 6 tasks of
    the whole grid (not its task row's 3), the same on every rank, down
    to none still active."""
    res = world[0]
    lines = [str(o["ckpt/stderr"]).splitlines() for o in res]
    assert lines[0] and all(ln == lines[0] for ln in lines)
    for ln in lines[0]:
        assert re.fullmatch(r"Cross-validating: iteration +\d+, \d/6 models "
                            r"converged", ln), ln
    assert lines[0][-1].endswith(" 6/6 models converged")
    saves = [[ln for ln in str(o["ckpt/stdout"]).splitlines()
              if ln.startswith("checkpoint at iteration")] for o in res]
    assert saves[0] and all(s == saves[0] for s in saves)
    assert saves[0][-1].endswith("; 0 tasks still active")


def test_dryrun_multichip(world):
    """The dry run's twin on the 2 x 2 mesh: two univariate and two mv
    iterations, each loglikelihood the JAX package's single-device one."""
    res, ref = world
    logl, mv_logl = ref["dryrun"]
    _close(res[0]["dryrun/logl"], logl, 1e-5)
    _close(res[0]["dryrun/mv_logl"], mv_logl, 1e-5)


def test_mesh_shapes(world):
    out = world[0][0]
    assert out["mesh/ranks"].tolist() == [[0, 1], [2, 3]]
    assert "does not fill" in str(out["mesh/error"])
    coords = [r["mesh/coords"].tolist() for r in world[0]]
    assert coords == [[0, 0], [0, 1], [1, 0], [1, 1]]


def test_ranks_agree(world):
    """Every rank gathers the same whole results, bit for bit: the ranks
    of a task row took every host-side branch alike."""
    res = world[0]
    for key, v in res[0].items():
        # a rank's place, whether it wrote, the stdout with its walls
        if key in ("mesh/coords", "ckpt_state/wrote", "ckpt/stdout"):
            continue
        for other in res[1:]:
            np.testing.assert_array_equal(other[key], v, err_msg=key)


def test_pad_geno_rows_matches_jax():
    rng = np.random.default_rng(1)
    codes = _codes(rng, 40, 603)
    j = jpad(m.PackedGenotypes.from_codes(codes), 8)
    t = pad_geno_rows(mt.PackedGenotypes.from_codes(codes, device="cpu"), 8)
    assert t.p == j.p == 608
    np.testing.assert_array_equal(t.words.numpy(), np.asarray(j.words))
    np.testing.assert_array_equal(t.mu.numpy(), np.asarray(j.mu))
    np.testing.assert_array_equal(t.inv_sd.numpy(), np.asarray(j.inv_sd))
