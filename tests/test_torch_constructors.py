"""The port's constructors and small API entries take every argument form
the JAX package's take (ROADMAP Queue 3, F4 and F5).

- ``PackedGenotypes.from_codes`` / ``from_packed`` / ``from_bed_bytes`` in
  each of the JAX package's call forms (``sample_major`` and ``dtype`` by
  position, a numpy dtype): with ``device="cpu"`` the words equal the JAX
  package's and mu / 1/sd equal its f32 ones (a float64 request here
  casts to the JAX package's f32, as it runs without x64); without
  ``device`` the card, or a RuntimeError where there is none.  The
  dataclass's own fields come in the JAX package's order.
- ``HostStreamedGenotypes(words_np=...)`` and ``.words_np`` as the JAX
  package's, positional too; ``.words`` reads the same array.
- ``utils.checkpoint.save_state(..., extra=)`` saves ``extra`` and never
  reads it back; ``models.pve.masked_var(..., axis=)``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.models.pve import masked_var as jmasked_var
from mendeliht_tpu.ops import streaming as jstreaming

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.genotype.snparray import (bed_payload_of_codes,
                                                   pack_codes)
from mendeliht_tpu_torch.models.pve import masked_var
from mendeliht_tpu_torch.models.state import IHTState
from mendeliht_tpu_torch.utils import checkpoint

N, P = 37, 11
CODES = np.random.default_rng(4).choice(np.arange(4, dtype=np.uint8),
                                        size=(N, P), p=[0.4, 0.1, 0.3, 0.2])


def _stats():
    j = m.PackedGenotypes.from_codes(CODES)
    return np.asarray(j.mu, np.float64), np.asarray(j.inv_sd, np.float64)


# each form: (constructor, positional args, keyword args), as the JAX
# package takes them; dtype numpy or a name, which both packages read
FORMS = {
    "codes": ("from_codes", lambda: (CODES,), {}),
    "codes-sample-major-positional": ("from_codes", lambda: (CODES, True),
                                      {}),
    "codes-snp-major-positional": ("from_codes", lambda: (CODES.T, False),
                                   {}),
    "codes-snp-major-keyword": ("from_codes", lambda: (CODES.T,),
                                dict(sample_major=False)),
    "codes-dtype-positional": ("from_codes",
                               lambda: (CODES, True, np.float64), {}),
    "codes-dtype-keyword": ("from_codes", lambda: (CODES,),
                            dict(dtype=jnp.float32)),
    "packed": ("from_packed", lambda: (pack_codes(CODES.T),) + _stats(),
               dict(n=N, p=P, has_missing=True)),
    "packed-dtype": ("from_packed", lambda: (pack_codes(CODES.T),)
                     + _stats(), dict(n=N, p=P, has_missing=True,
                                      dtype="float64")),
    "bed": ("from_bed_bytes",
            lambda: (bed_payload_of_codes(CODES.T).ravel(), N, P), {}),
    "bed-dtype-positional": ("from_bed_bytes", lambda: (
        bed_payload_of_codes(CODES.T).ravel(), N, P, np.float64), {}),
    "bed-keywords": ("from_bed_bytes",
                     lambda: (bed_payload_of_codes(CODES.T).ravel(),),
                     dict(n=N, p=P, dtype=np.float32)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_genotype_constructors_take_jax_forms(form):
    name, args, kw = FORMS[form]
    want = getattr(m.PackedGenotypes, name)(*args(), **kw)
    got = getattr(mt.PackedGenotypes, name)(*args(), **kw, device="cpu")
    assert (got.n, got.p, got.has_missing) == (want.n, want.p,
                                               want.has_missing)
    np.testing.assert_array_equal(got.words.numpy(), np.asarray(want.words))
    for field in ("mu", "inv_sd"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy().astype(np.asarray(
                getattr(want, field)).dtype), np.asarray(getattr(want, field)))
    if torch.cuda.is_available():
        card = getattr(mt.PackedGenotypes, name)(*args(), **kw)
        assert card.device.type == "cuda"
        assert torch.equal(card.words.cpu(), got.words)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(mt.PackedGenotypes, name)(*args(), **kw)


def test_genotype_fields_in_jax_order():
    assert ([f.name for f in dataclasses.fields(mt.PackedGenotypes)]
            == [f.name for f in dataclasses.fields(m.PackedGenotypes)])


def test_host_streamed_genotypes_words_np():
    j = jstreaming.HostStreamedGenotypes.from_snparray(
        m.PackedGenotypes.from_codes(CODES), block_bytes=4096)
    t = mt.PackedGenotypes.from_codes(CODES, device="cpu")
    words = np.ascontiguousarray(np.asarray(j.words_np))
    by_kw = mt.HostStreamedGenotypes(words_np=words, mu=t.mu, inv_sd=t.inv_sd,
                                     n=N, p=P, has_missing=True,
                                     block_bytes=4096)
    by_pos = mt.HostStreamedGenotypes(words, t.mu, t.inv_sd, N, P, True, 4096)
    for s in (by_kw, by_pos):
        assert s.words_np is words and s.words is words
        assert s.n_pad == j.n_pad and s.block_p == j.block_p
    demoted = mt.HostStreamedGenotypes.from_snparray(t, block_bytes=4096)
    np.testing.assert_array_equal(demoted.words_np, np.asarray(j.words_np))
    got = mt.fit_iht(np.random.default_rng(1).standard_normal(N), by_kw, k=2,
                     verbose=False)
    want = mt.fit_iht(np.random.default_rng(1).standard_normal(N), t, k=2,
                      verbose=False)
    np.testing.assert_array_equal(got.beta, want.beta)


def test_save_state_keeps_extra(tmp_path):
    rng = np.random.default_rng(2)
    arrays = {f.name: rng.standard_normal((2, 3)).astype(np.float32)
              for f in dataclasses.fields(IHTState)}
    arrays.update(iteration=np.asarray(4), k=np.asarray([1, 2]),
                  active=np.asarray([True, False]))
    st = IHTState.from_numpy(arrays, "cpu")
    path = checkpoint.save_state(str(tmp_path), st, 4,
                                 extra={"ks": np.arange(3), "folds": [1, 2]})
    payload = torch.load(path, weights_only=True)
    np.testing.assert_array_equal(payload["extra"]["ks"].numpy(), np.arange(3))
    np.testing.assert_array_equal(payload["extra"]["folds"].numpy(), [1, 2])
    back, step = checkpoint.restore_state(str(tmp_path), st)
    assert step == 4 and back.iteration == 4
    for f in dataclasses.fields(st):
        if f.name != "iteration":
            assert torch.equal(getattr(back, f.name), getattr(st, f.name))


@pytest.mark.parametrize("axis", [-1, 1, 0])
def test_masked_var_axis(axis):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 9)).astype(np.float32)
    mask = np.ones((4, 9), np.float32)
    mask[:, 7:] = 0.0
    want = np.asarray(jmasked_var(jnp.asarray(x), jnp.asarray(mask), 7,
                                  axis=axis))
    got = masked_var(torch.from_numpy(x), torch.from_numpy(mask), 7,
                     axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
