"""The port's multi-process layer (``mendeliht_tpu_torch.parallel.
multihost``) against the JAX package, the twin of tests/test_multihost.py.

Two gloo rank processes on the CPU (``tests/torch_multihost_worker.py``)
each read their own SNP shard of a PLINK ``.bed`` (``load_bed_shard``) and
run ``fit_iht`` through ``ShardedPackedOp`` on a 1 x 2 mesh; the result
must be the JAX package's single-process fit: the same support, betas and
c within 1e-3 and logl within 1e-2 (the JAX test's bounds: the sharded
sums run in another f32 order), both ranks the same result.  Each rank's
shard holds the JAX genotypes' quad words and stats of its SNP rows, pad
rows zero; a missing call in one shard sets ``has_missing`` on both.  A
rank that leaves a collective makes the other fail at the group's timeout
instead of hanging.  The numpy metrics and the shard arithmetic equal the
JAX package's.
"""

import numpy as np
import pytest

import mendeliht_tpu as m
from mendeliht_tpu.parallel import multihost as jmh

from mendeliht_tpu_torch.genotype.snparray import (_LANE, _ceil_to,
                                                   bed_payload_of_codes)
from mendeliht_tpu_torch.parallel import multihost as mh

from torch_multihost_worker import World

DESYNC_TIMEOUT = 1.0        # s, the desynchronised group's timeout


def test_shard_rows_padding():
    p_pad, ranges = mh.shard_rows(10, 4)
    assert p_pad == 16
    assert ranges == [(0, 4), (4, 8), (8, 10), (10, 10)]
    p_pad, ranges = mh.shard_rows(8, 2)
    assert p_pad == 8 and ranges == [(0, 4), (4, 8)]
    p_pad, ranges = mh.shard_rows(100, 3)
    assert p_pad == 108 and ranges[0] == (0, 36)
    for p, ns in ((10, 4), (603, 8), (1_000_000, 3), (5, 7)):
        assert mh.shard_rows(p, ns) == jmh.shard_rows(p, ns)


def test_bed_dims(tmp_path):
    rng = np.random.default_rng(7)
    x, _ = m.simulate_random_snparray(str(tmp_path / "g.bed"), 37, 53,
                                      rng=rng)
    m.make_bim_fam_files(x, rng.standard_normal(37), str(tmp_path / "g"))
    assert mh.bed_dims(str(tmp_path / "g")) == (37, 53)
    assert mh.bed_dims(str(tmp_path / "g")) == jmh.bed_dims(
        str(tmp_path / "g"))


def test_scaling_metrics():
    nnz = mh.nnz_throughput(10_000, 1_000_000, 5, 2.0)
    assert nnz == 10_000 * 1_000_000 * 5 / 2.0
    assert nnz == jmh.nnz_throughput(10_000, 1_000_000, 5, 2.0)
    assert mh.scaling_efficiency(1e9, 1.8e9, 2) == pytest.approx(0.9)


@pytest.mark.parametrize("kw", [dict(B=100, n_task=1, n_snp=1),
                                dict(B=100, n_task=1, n_snp=2),
                                dict(B=100, n_task=4, n_snp=2),
                                dict(B=3, n_task=1, n_snp=8,
                                     backtracks_per_iter=1.5)])
def test_comm_model(kw):
    """The per-iteration byte model: the JAX package's numbers, and its
    test's relations."""
    got = mh.comm_model(500_000, 1_000_000, **kw)
    assert got == pytest.approx(jmh.comm_model(500_000, 1_000_000, **kw))
    n4 = _ceil_to(-(-500_000 // 4), _LANE)
    assert got["local_bytes_per_iter"] == pytest.approx(
        1_000_000 * n4 / kw["n_snp"])
    if kw["n_snp"] == 1:
        assert got["collective_bytes_per_iter"] == 0
        assert got["predicted_efficiency"] == pytest.approx(1.0)
    else:
        assert 0 < got["predicted_efficiency"] < 1.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two ranks' results and the JAX single-process fit."""
    tmp = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(20260820)
    n, p, k = 200, 300, 4
    prefix = str(tmp / "mh")
    x, _ = m.simulate_random_snparray(prefix + ".bed", n, p, rng=rng)
    y, _, _ = m.simulate_random_response(x, k, m.Normal(), rng=rng)
    np.savetxt(prefix + ".phen", y)
    m.make_bim_fam_files(x, y, prefix)
    # 11 x 10 codes, missing calls in SNPs 8-9 (the second of 2 shards)
    codes = np.random.default_rng(3).choice([0, 2, 3], size=(10, 11))
    codes[8:, ::3] = 1
    miss = str(tmp / "miss")
    with open(miss + ".bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        f.write(bed_payload_of_codes(codes).tobytes())
    with open(miss + ".fam", "w") as f:
        f.writelines(f"{i} {i} 0 0 1 0\n" for i in range(11))
    w = World("multihost", 2, {"prefix": prefix, "k": k,
                               "missing_prefix": miss,
                               "desync_timeout": DESYNC_TIMEOUT}, tmp)
    r0 = m.fit_iht(y, x, k=k, max_iter=50, verbose=False)
    return w.results(), r0, x


def test_two_process_fit_matches_single(world):
    res, r0, _ = world
    out = res[0]
    assert int(out["fit/p_true"]) == 300
    np.testing.assert_array_equal(out["fit/support"],
                                  np.flatnonzero(r0.beta))
    np.testing.assert_allclose(out["fit/beta"], r0.beta[r0.beta != 0],
                               atol=1e-3)
    np.testing.assert_allclose(out["fit/c"], r0.c, atol=1e-3)
    assert float(out["fit/logl"]) == pytest.approx(r0.logl, abs=1e-2)


def test_ranks_report_the_same_fit(world):
    res = world[0]
    for key in res[0]:
        if key.startswith("fit/"):
            np.testing.assert_array_equal(res[1][key], res[0][key],
                                          err_msg=key)


@pytest.mark.parametrize("rank", [0, 1])
def test_load_bed_shard_holds_its_rows(world, rank):
    """Rank r holds SNPs [152 r, 152 (r + 1)) of the 300 (shard_rows pads
    to 304, whole quad rows), as the JAX package's genotypes hold them;
    pad rows zero with inv_sd 0."""
    res, _, x = world
    out = res[rank]
    lo, hi = mh.shard_rows(300, 2)[1][rank]
    words = np.asarray(x.words)
    assert out["shard/words"].shape == (38, words.shape[1])
    np.testing.assert_array_equal(out["shard/words"][:-(-(hi - lo) // 4)],
                                  words[lo // 4:-(-hi // 4)])
    np.testing.assert_array_equal(out["shard/words"][-(-(hi - lo) // 4):], 0)
    np.testing.assert_array_equal(out["shard/mu"][:hi - lo],
                                  np.asarray(x.mu)[lo:hi])
    np.testing.assert_array_equal(out["shard/inv_sd"][:hi - lo],
                                  np.asarray(x.inv_sd)[lo:hi])
    assert not np.any(out["shard/inv_sd"][hi - lo:])
    assert not bool(out["fit/has_missing"])


def test_missing_calls_in_one_shard_reach_every_rank(world):
    assert [bool(r["missing/has_missing"]) for r in world[0]] == [True, True]


def test_desynchronised_rank_fails_at_timeout(world):
    """Rank 1 stays out of a collective of a group with a 1 s timeout:
    rank 0 raises within a few timeouts rather than hanging."""
    out = world[0][0]
    assert "timed out" in str(out["desync/error"]).lower(), \
        f"rank 0's collective did not time out: {out['desync/error']!r}"
    assert (0.9 * DESYNC_TIMEOUT <= float(out["desync/seconds"])
            < 10 * DESYNC_TIMEOUT)
