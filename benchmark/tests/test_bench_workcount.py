"""The score's work counts, by hand, at the four cells' shapes."""

import pytest

from benchmark import workcount

PEAK = workcount.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("n, m, ops, nbytes", [
    # gauss10k.cv: 2 * 1e4 * 1e6 * 100; 2.5e9 + 4e6 + 4e8 bytes
    (10_000, 100, 2_000_000_000_000, 2_904_000_000),
    # gauss10k.fit
    (10_000, 1, 20_000_000_000, 2_504_040_000),
    # gauss120k.cv: 2 * 1.2e5 * 1e6 * 100; 3e10 + 4.8e7 + 4e8
    (120_000, 100, 24_000_000_000_000, 30_448_000_000),
    # gauss120k.fit
    (120_000, 1, 240_000_000_000, 30_004_480_000),
])
def test_score_counts(n, m, ops, nbytes):
    p = 1_000_000
    assert workcount.score_ops(n, p, m) == ops
    assert workcount.score_bytes(n, p, m) == nbytes
    bound = workcount.score_bound_s(n, p, m, PEAK)
    assert bound == max(ops / 1979e12, nbytes / 3.35e12)


def test_bounds_by_operations_and_bytes():
    # m = 100 is bound by operations, m = 1 by bytes
    p = 1_000_000
    assert workcount.score_bound_s(10_000, p, 100, PEAK) == pytest.approx(
        1.0106e-3, rel=1e-4)
    assert workcount.score_bound_s(120_000, p, 1, PEAK) == pytest.approx(
        8.956e-3, rel=1e-3)


def test_unknown_card_raises():
    with pytest.raises(ValueError):
        workcount.peaks("some other card")
