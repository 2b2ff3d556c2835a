"""Checkpoint / resume of the port (``utils/checkpoint.py``,
``univariate.run_segmented``) on the CPU, against the JAX package's.

The port's step is deterministic given its state, so within the port a
checkpointed run equals the plain run, and a run killed by a small
``max_iter`` and resumed equals the uninterrupted run, bit for bit.
Against the JAX package (its orbax checkpoints) the cv mse is held within
1e-4 relative with the same best k, the tolerance of tests/test_torch_cv.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.genotype.snparray import PackedGenotypes as JG
from mendeliht_tpu.models.mv import cv_mv_iht as jcv_mv
from mendeliht_tpu.ops import streaming as jstreaming

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.models import fit as tfit
from mendeliht_tpu_torch.models.initialize import init_state
from mendeliht_tpu_torch.models.mv import cv_mv_iht as tcv_mv
from mendeliht_tpu_torch.utils import checkpoint as ckpt

PATH = [2, 4, 6]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's many small ops (as in
    tests/test_torch_mv.py), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(g):
    return mt.PackedGenotypes.from_numpy(
        np.asarray(g.words), np.asarray(g.mu), np.asarray(g.inv_sd),
        n=g.n, p=g.p, has_missing=g.has_missing, device="cpu")


@pytest.fixture(scope="module")
def problem():
    """The JAX package's tests/test_checkpoint.py problem."""
    rng = np.random.default_rng(123)
    x, _ = m.simulate_random_snparray(None, 300, 400, rng=rng)
    y, _, _ = m.simulate_random_response(x, 4, m.Normal(), rng=rng)
    folds = np.tile(np.arange(1, 4), 100)
    return x, _port(x), y, folds


@pytest.fixture(scope="module")
def plain(problem):
    """(the port's plain cv mse, the JAX package's) at max_iter 100."""
    x, t, y, folds = problem
    kw = dict(path=PATH, q=3, folds=folds, verbose=False)
    return mt.cv_iht(y, t, **kw), m.cv_iht(y, x, **kw)


def _agree_with_jax(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.argmin(got) == np.argmin(want)


def test_checkpointed_cv_equals_plain(problem, plain, tmp_path):
    x, t, y, folds = problem
    kw = dict(path=PATH, q=3, folds=folds, verbose=False,
              checkpoint_every=3)
    got = mt.cv_iht(y, t, checkpoint_dir=str(tmp_path / "t"), **kw)
    np.testing.assert_array_equal(got, plain[0])
    steps = sorted(ckpt.all_steps(str(tmp_path / "t")))
    assert len(steps) == 2 and steps[0] % 3 == 0     # the newest two
    _agree_with_jax(got, m.cv_iht(y, x, checkpoint_dir=str(tmp_path / "j"),
                                  **kw))


def test_resumed_cv_equals_uninterrupted(problem, plain, tmp_path, capsys):
    """A cv killed by a small max_iter (its last checkpoint at iteration
    4), then run again with the full budget, resumes and gives the
    uninterrupted run's mse bit for bit; the JAX package's resumed run
    agrees."""
    x, t, y, folds = problem
    kw = dict(path=PATH, q=3, folds=folds)
    d = str(tmp_path / "t")
    mt.cv_iht(y, t, checkpoint_dir=d, checkpoint_every=2, max_iter=5,
              verbose=False, **kw)
    assert sorted(ckpt.all_steps(d)) == [2, 4]
    capsys.readouterr()
    got = mt.cv_iht(y, t, checkpoint_dir=d, checkpoint_every=50,
                    verbose=True, **kw)
    assert "resuming from checkpoint step 4" in capsys.readouterr().out
    np.testing.assert_array_equal(got, plain[0])
    dj = str(tmp_path / "j")
    m.cv_iht(y, x, checkpoint_dir=dj, checkpoint_every=2, max_iter=5,
             verbose=False, **kw)
    _agree_with_jax(got, m.cv_iht(y, x, checkpoint_dir=dj,
                                  checkpoint_every=50, verbose=False, **kw))


def _state(problem, B=2):
    _, t, y, _ = problem
    op, data, cfg, _ = tfit.build_fit(y, t, None, k=4)
    return init_state(op, data, cfg, [4] * B,
                      data.sample_mask[None, :].expand(B, op.n_pad))


def test_keeps_two_steps_and_writes_atomically(problem, tmp_path,
                                                monkeypatch):
    st = _state(problem)
    d = str(tmp_path)
    for step in (1, 2, 5, 7):
        path = ckpt.save_state(d, dataclasses.replace(st, iteration=step),
                               step)
        assert path == os.path.join(d, f"step_{step}")
    assert sorted(ckpt.all_steps(d)) == [5, 7] and ckpt.latest_step(d) == 7
    assert sorted(os.listdir(d)) == ["step_5", "step_7"]

    def killed(obj, f):               # a kill part way through the write
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_state(d, st, 9)
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 7                    # no corrupt step 9
    assert sorted(os.listdir(d)) == ["step_5", "step_7"]
    back, step = ckpt.restore_state(d, st)
    assert step == 7 and back.iteration == 7
    assert ckpt.restore_state(str(tmp_path / "none"), st) is None
    assert ckpt.all_steps(str(tmp_path / "none")) == []


def test_restore_lands_on_like_device_and_dtype(problem, tmp_path):
    st = _state(problem)
    st = dataclasses.replace(st, b=torch.randn_like(st.b), iteration=3)
    ckpt.save_state(str(tmp_path), st, 3)
    payload = torch.load(tmp_path / "step_3", weights_only=True)
    assert payload["iteration"] == 3 and isinstance(payload["iteration"],
                                                    int)
    assert payload["b"].device.type == "cpu"
    like = dataclasses.replace(
        st, b=st.b.double(), mu=torch.empty(st.mu.shape, device="meta"),
        k=st.k.to(torch.int32), iteration=0)
    back, step = ckpt.restore_state(str(tmp_path), like)
    assert step == 3 and back.iteration == 3
    assert back.b.dtype == torch.float64 and back.k.dtype == torch.int32
    assert back.mu.device.type == "meta"
    assert torch.equal(back.b, st.b.double())
    assert torch.equal(back.sel_valid, st.sel_valid)
    assert back.sel_valid.dtype == torch.bool
    for f in dataclasses.fields(st):
        v = getattr(back, f.name)
        if isinstance(v, torch.Tensor):
            assert v.shape == getattr(st, f.name).shape


def test_checkpoint_every_must_be_positive(problem, tmp_path):
    x, t, y, folds = problem
    with pytest.raises(ValueError, match="checkpoint_every"):
        mt.cv_iht(y, t, path=[2], q=3, folds=folds, verbose=False,
                  checkpoint_dir=str(tmp_path), checkpoint_every=0)


# ---------------------------------------------------------------------------
# the multivariate cv, a chunk a directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mv_problem():
    rng = np.random.default_rng(605)
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(150, 100),
                       p=[0.5, 0.0, 0.3, 0.2])
    g = JG.from_codes(codes)
    Xd = g.to_dense_standardized()
    B = np.zeros((2, g.p))
    for j in rng.choice(g.p, 3, replace=False):
        B[rng.integers(0, 2), j] = rng.standard_normal() * 2
    Y = B @ Xd.T + 0.1 * rng.standard_normal((2, g.n))
    folds = np.random.default_rng(5).integers(1, 4, size=g.n)
    return g, _port(g), Y, folds


def test_mv_cv_checkpoints_a_chunk_a_directory(mv_problem, tmp_path):
    g, t, Y, folds = mv_problem
    kw = dict(path=range(1, 5), q=3, folds=folds, verbose=False,
              task_chunk=5)
    plain = tcv_mv(Y, t, **kw)
    d = str(tmp_path / "t")
    tcv_mv(Y, t, checkpoint_dir=d, checkpoint_every=2, max_iter=4, **kw)
    assert sorted(os.listdir(d)) == ["chunk0", "chunk10", "chunk5"]
    assert all(ckpt.latest_step(os.path.join(d, c)) == 3
               for c in os.listdir(d))
    got = tcv_mv(Y, t, checkpoint_dir=d, checkpoint_every=2, **kw)
    np.testing.assert_array_equal(got, plain)
    kw.pop("task_chunk")
    one = str(tmp_path / "one")            # one chunk: the directory itself
    np.testing.assert_array_equal(
        tcv_mv(Y, t, checkpoint_dir=one, checkpoint_every=3, **kw),
        tcv_mv(Y, t, **kw))
    assert ckpt.latest_step(one) is not None
    want = jcv_mv(Y, g, checkpoint_dir=str(tmp_path / "j"),
                  checkpoint_every=3, **kw)
    _agree_with_jax(got, want)


# ---------------------------------------------------------------------------
# streamed fits and cvs
# ---------------------------------------------------------------------------

def _stream(t):
    return mt.HostStreamedGenotypes.from_snparray(t, block_bytes=4096,
                                                  resident_bytes=0)


def test_streamed_fit_resumes_bit_for_bit(problem, tmp_path):
    """A streamed fit killed by max_iter and run again resumes from its
    checkpoint and equals the uninterrupted streamed fit; a resident fit
    ignores checkpoint_dir, as the JAX package's does."""
    x, t, y, _ = problem
    kw = dict(k=4, verbose=False)
    whole = mt.fit_iht(y, _stream(t), **kw)
    d = str(tmp_path / "fit")
    mt.fit_iht(y, _stream(t), checkpoint_dir=d, checkpoint_every=1,
               max_iter=3, **kw)
    assert sorted(ckpt.all_steps(d)) == [1, 2]
    got = mt.fit_iht(y, _stream(t), checkpoint_dir=d, checkpoint_every=1,
                     **kw)
    np.testing.assert_array_equal(got.beta, whole.beta)
    assert (got.logl, got.iter) == (whole.logl, whole.iter)
    want = m.fit_iht(y, jstreaming.HostStreamedGenotypes.from_snparray(
        x, block_bytes=40960, resident_bytes=0), **kw)
    assert np.flatnonzero(got.beta).tolist() == \
        np.flatnonzero(want.beta).tolist()
    assert got.logl == pytest.approx(want.logl, rel=1e-4)
    r = str(tmp_path / "resident")
    mt.fit_iht(y, t, checkpoint_dir=r, **kw)
    assert not os.path.exists(r)


def test_streamed_cv_resumes_bit_for_bit(problem, plain, tmp_path, capsys):
    x, t, y, folds = problem
    kw = dict(path=PATH, q=3, folds=folds, verbose=False)
    whole = mt.cv_iht(y, _stream(t), **kw)
    d = str(tmp_path / "cv")
    mt.cv_iht(y, _stream(t), checkpoint_dir=d, checkpoint_every=2,
              max_iter=5, **kw)
    capsys.readouterr()
    got = mt.cv_iht(y, _stream(t), checkpoint_dir=d, checkpoint_every=2,
                    show_progress=True, **kw)
    err = capsys.readouterr().err
    np.testing.assert_array_equal(got, whole)
    assert err.splitlines()[0].startswith("Cross-validating: iteration    6")
    _agree_with_jax(got, plain[1])
