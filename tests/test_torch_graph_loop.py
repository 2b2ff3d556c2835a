"""The single-task fit's iteration replayed as CUDA graphs
(``models/replay.py``).

On the CPU: the three pieces the graphs record, run eagerly through the
same static buffers, equal ``univariate._iteration`` bit for bit over a
whole solve; the engagement rule keeps every other solve on the eager
loop; a cache entry's key holds the operator's statistics by address.

On the card (marker ``cuda``): replayed fits equal the eager fits bit for
bit, through one entry and across keys, in float64 too, and count the
score launches the eager fits count.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import replay, univariate
from mendeliht_tpu_torch.models.fit import build_fit
from mendeliht_tpu_torch.models.initialize import init_state
from mendeliht_tpu_torch.models.state import FitConfig
from mendeliht_tpu_torch.ops import kernels
from mendeliht_tpu_torch.ops.linalg import PackedOp
from mendeliht_tpu_torch.ops.streaming import StreamedPackedOp
from mendeliht_tpu_torch.parallel.sharded_ops import ShardedPackedOp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, n, p, d, device):
    rng = np.random.default_rng(seed)
    x, _ = mt.simulate_random_snparray(None, n, p, rng=rng, device=device)
    y, _, _ = mt.simulate_random_response(x, 5, d, rng=rng)
    return x, y


def _same(a, b):
    """Bit for bit, NaN where NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.fixture
def long_steps(monkeypatch):
    """Every step size 4 times the reference's, so steps backtrack."""
    stepsize = univariate._stepsize
    monkeypatch.setattr(univariate, "_stepsize",
                        lambda *a: 4.0 * stepsize(*a))


@pytest.mark.parametrize("d", ["normal", "bernoulli"])
def test_pieces_equal_iteration_over_a_solve(d, request):
    """The pieces through the static buffers, one iteration at a time, give
    the eager iteration's state bit for bit, backtracks included."""
    if d == "normal":
        request.getfixturevalue("long_steps")
    fam = mt.Normal() if d == "normal" else mt.Bernoulli()
    x, y = _problem(4 if d == "normal" else 2, 300, 600, fam, "cpu")
    op, data, cfg, k = build_fit(y, x, k=5, d=fam)
    st = init_state(op, data, cfg, [k], data.sample_mask[None, :])
    loop = replay.Loop(replay.key(op, data, cfg, st), data, st)
    loop.load(data, st)
    run = lambda i: loop.pieces[i](op, cfg)              # noqa: E731
    it, backtracks = st.iteration, 0
    while it < cfg.max_iter - 1 and bool(st.active.any()):
        st = univariate._iteration(op, data, cfg, st)
        it = replay.advance(loop, cfg, it, it + 1, run)
        got = loop.result(it)
        assert it == st.iteration
        for f in replay._FIELDS:
            assert _same(getattr(got, f), getattr(st, f)), (it, f)
        backtracks += int(st.backtracks.sum())
    assert not bool(st.active.any())                      # converged
    assert backtracks > 0
    # and no further iteration once every task converged
    assert replay.advance(loop, cfg, it, it + 5, run) == it


@pytest.mark.parametrize("d", ["normal", "bernoulli"])
def test_solve_through_the_pieces_equals_the_eager_fit(d, monkeypatch):
    """``fit_iht`` through ``replay.solve``, the pieces run eagerly in
    place of their graphs, gives the eager fit bit for bit, twice through
    one entry."""
    fam = mt.Normal() if d == "normal" else mt.Bernoulli()
    x, y = _problem(4 if d == "normal" else 2, 300, 600, fam, "cpu")
    y2 = np.random.default_rng(7).permutation(y)
    want = [mt.fit_iht(v, x, k=5, d=fam, verbose=False) for v in (y, y2)]
    monkeypatch.setattr(replay, "engaged", lambda *a: True)
    monkeypatch.setattr(replay.Loop, "replay",
                        lambda self, i, op, cfg: self.pieces[i](op, cfg))
    got = [mt.fit_iht(v, x, k=5, d=fam, verbose=False) for v in (y, y2)]
    assert x.replay_loop is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.beta, b.beta)
        np.testing.assert_array_equal(a.c, b.c)
        assert (a.logl, a.iter, a.sigma_g) == (b.logl, b.iter, b.sigma_g)


def _cuda_stub():
    """A PackedOp whose genotypes say they lie on the card (nothing is
    allocated there)."""
    geno = SimpleNamespace(mu=torch.zeros(8), inv_sd=torch.ones(8),
                           device=torch.device("cuda", 0))
    return PackedOp(geno)


_EAGER = {
    "cpu": dict(op="cpu"),
    "tasks": dict(B=2),
    "log_iters": dict(cfg=dict(log_iters=True)),
    "debias": dict(cfg=dict(debias=True)),
    "est_r": dict(cfg=dict(dist="negativebinomial", link="log",
                           est_r="newton")),
    "streamed": dict(op=StreamedPackedOp.__new__(StreamedPackedOp)),
    "sharded": dict(op=ShardedPackedOp.__new__(ShardedPackedOp)),
    "checkpoint": dict(segments=dict(checkpoint_dir="ckpt",
                                     checkpoint_every=5)),
    "progress": dict(segments=dict(progress=True)),
}


@pytest.mark.parametrize("case", sorted(_EAGER) + ["replay"])
def test_engagement(case):
    """Only a single-task solve on a single-device PackedOp on the card,
    whose iteration reads nothing on the host, in one segment, replays."""
    spec = _EAGER.get(case, {})
    op = spec.get("op", _cuda_stub())
    if op == "cpu":
        x, _ = _problem(1, 40, 24, mt.Normal(), "cpu")
        op = PackedOp(x)
    cfg = FitConfig(**spec.get("cfg", {}))
    got = replay.engaged(op, cfg, spec.get("B", 1), spec.get("segments", {}))
    assert got == (case == "replay")


def test_entry_keys_on_the_statistics_addresses():
    """Two operators over one genotypes whose mu differ only in address
    get entries of their own; the same operator finds its entry again."""
    x, y = _problem(1, 60, 40, mt.Normal(), "cpu")
    op, data, cfg, k = build_fit(y, x, k=3)
    st = init_state(op, data, cfg, [k], data.sample_mask[None, :])
    other = PackedOp(x)
    other.mu = op.mu.clone()
    k1, k2 = (replay.key(o, data, cfg, st) for o in (op, other))
    assert k1 != k2
    assert k1[:-1] == k2[:-1]
    assert [a != b for a, b in zip(k1[-1], k2[-1])] == [
        False, False, True, False, False]
    first = replay.entry(op, data, cfg, st)
    assert replay.entry(op, data, cfg, st) is first
    second = replay.entry(other, data, cfg, st)
    assert second is not first and x.replay_loop is second
    assert replay.entry(other, data, cfg, st) is second


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def eager(monkeypatch):
    """A fit with replay turned off, and the replaying one."""
    def fit(y, x, replayed, **kw):
        with monkeypatch.context() as m:
            if not replayed:
                m.setattr(replay, "engaged", lambda *a: False)
            return mt.fit_iht(y, x, verbose=False, **kw)
    return fit


def _equal_fits(a, b):
    np.testing.assert_array_equal(a.beta, b.beta)
    np.testing.assert_array_equal(a.c, b.c)
    assert (a.logl, a.iter) == (b.logl, b.iter)


def _options(x, rng):
    """fit_iht's options beside the family (``options_on_card``)."""
    n, p = x.n, x.p
    return {
        "normal": dict(),
        "bernoulli": dict(d=mt.Bernoulli()),
        "poisson": dict(d=mt.Poisson()),
        "group": dict(k=2, J=5, group=np.arange(p) // 20 + 1),
        "weight_zkeep": dict(weight=rng.uniform(0.5, 1.5, p),
                             z=np.column_stack([np.ones(n),
                                                rng.normal(size=n)]),
                             zkeep=[True, False]),
        "init_beta": dict(init_beta=True),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["normal", "bernoulli", "poisson", "group",
                                  "weight_zkeep", "init_beta"])
def test_replayed_fit_equals_eager_on_card(cuda_device, eager, case,
                                           long_steps):
    """Bit for bit, with every step 4 times long so steps backtrack, for
    the families and options a replayed fit takes."""
    fam = {"bernoulli": mt.Bernoulli(), "poisson": mt.Poisson()}.get(
        case, mt.Normal())
    x, y = _problem(4 if case == "normal" else 2, 2000, 20000, fam,
                    cuda_device)
    kw = dict(dict(k=10), **_options(x, np.random.default_rng(8))[case])
    want = eager(y, x, False, **kw)
    assert x.replay_loop is None
    got = eager(y, x, True, **kw)
    assert x.replay_loop is not None and x.replay_loop.graphs is not None
    _equal_fits(got, want)


@pytest.mark.cuda
def test_one_entry_serves_fits_of_other_y(cuda_device, eager):
    x, y = _problem(3, 2000, 20000, mt.Normal(), cuda_device)
    y2 = np.random.default_rng(5).permutation(y)
    first = eager(y, x, True, k=10)
    loop, graphs = x.replay_loop, x.replay_loop.graphs
    second = eager(y2, x, True, k=10)
    assert x.replay_loop is loop and loop.graphs is graphs
    _equal_fits(first, eager(y, x, False, k=10))
    _equal_fits(second, eager(y2, x, False, k=10))


@pytest.mark.cuda
def test_changed_k_or_n_captures_anew(cuda_device, eager):
    x, y = _problem(3, 2000, 20000, mt.Normal(), cuda_device)
    eager(y, x, True, k=10)
    loop = x.replay_loop
    got = eager(y, x, True, k=12)
    assert x.replay_loop is not loop and x.replay_loop.graphs is not None
    _equal_fits(got, eager(y, x, False, k=12))
    x2, y2 = _problem(3, 1500, 20000, mt.Normal(), cuda_device)
    got = eager(y2, x2, True, k=10)
    assert x2.replay_loop is not None and x2.replay_loop.key != loop.key
    _equal_fits(got, eager(y2, x2, False, k=10))


@pytest.mark.cuda
def test_float64_fit_replays_only_on_its_own_mu(cuda_device, eager,
                                                monkeypatch):
    """Each float64 fit on float32 genotypes casts mu and 1/sd anew; the
    entry it replays holds that call's addresses."""
    x, y = _problem(3, 2000, 20000, mt.Normal(), cuda_device)
    seen = []
    solve = replay.solve

    def recording(op, data, cfg, st):
        out = solve(op, data, cfg, st)
        seen.append((op.mu.data_ptr(), op.inv_sd.data_ptr(),
                     op.geno.replay_loop.key[-1]))
        return out
    monkeypatch.setattr(replay, "solve", recording)
    for yy in (y, np.random.default_rng(6).permutation(y), y):
        got = eager(yy, x, True, k=10, dtype=torch.float64)
        _equal_fits(got, eager(yy, x, False, k=10, dtype=torch.float64))
    assert len(seen) == 3
    for mu, inv_sd, ptrs in seen:
        assert ptrs[2:4] == (mu, inv_sd)


@pytest.mark.cuda
def test_replayed_fit_counts_the_eager_launches(cuda_device, eager):
    x, y = _problem(3, 2000, 20000, mt.Normal(), cuda_device)

    def launches(replayed):
        before = dict(kernels.LAUNCHES)
        res = eager(y, x, replayed, k=10)
        return res, {n: kernels.LAUNCHES[n] - c for n, c in before.items()
                     if kernels.LAUNCHES[n] != c}
    want, counted = launches(False)
    assert counted == {"xt_dots_words_t": want.iter + 1}
    for _ in range(2):                       # the capturing fit, then not
        got, n = launches(True)
        assert n == counted
        _equal_fits(got, want)
