"""What the score X'R has to do, whatever implements it, and the card's
peaks to hold it against.

The score at width m on n samples and p SNPs is 2 n p m operations (a
multiply and an add a genotype and column), and it has to read the n p / 4
bytes of 2-bit genotypes and the 4 n m bytes of an f32 R once and write the
4 p m bytes of its f32 output once.  Its least time on the card is the
larger of the operations at the card's fastest dense rate (int8 and fp8,
1,979 T/s on an H100 SXM) and the bytes at its memory bandwidth.  Digit
planes, layouts and padding of an implementation are not counted: a
kernel that does more work than the function needs reads a lower share.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"ops_per_s": 1979e12, "bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict:
    """The data-sheet peaks of a card; raises for a card not in PEAKS
    rather than guess."""
    if device_name not in PEAKS:
        raise ValueError(f"no data-sheet peaks for {device_name!r}")
    return PEAKS[device_name]


def score_ops(n: int, p: int, m: int) -> int:
    return 2 * n * p * m


def score_bytes(n: int, p: int, m: int) -> int:
    return n * p // 4 + 4 * n * m + 4 * p * m


def score_bound_s(n: int, p: int, m: int, peak: dict) -> float:
    """The least seconds a score at width m can take on a card of ``peak``."""
    return max(score_ops(n, p, m) / peak["ops_per_s"],
               score_bytes(n, p, m) / peak["bytes_per_s"])
