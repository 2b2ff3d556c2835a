"""PLINK 1.9 binary (.bed/.bim/.fam) reader and writer (the JAX package's
``genotype/plink.py``; reference: SnpArrays.SnpData ingestion,
src/wrapper.jl:469-478).

``.bed`` is SNP-major, 2 bits a genotype; :func:`read_plink` repacks it
into the quad words on the genotypes' device
(``PackedGenotypes.from_bed_bytes``), and :func:`write_plink_bed` writes
either a code matrix (the JAX package's numpy packer) or packed genotypes
(their ``.bed`` rows made on their device, a chunk of SNPs at a time).
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import numpy as np
import torch

from .snparray import PackedGenotypes, bed_chunks, bed_payload_of_codes
from ..utils.device import float_dtype

_BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


@dataclasses.dataclass
class SnpData:
    """PLINK trio: packed genotypes + variant/person metadata.

    ``snp_info`` columns mirror .bim: chromosome, snpid, genetic_distance,
    position, allele1, allele2.  ``person_info`` mirrors .fam: fid, iid,
    father, mother, sex, then phenotype columns (6, 7, ... as strings).
    """
    snparray: PackedGenotypes
    snp_info: dict          # column name -> np.ndarray
    person_info: dict       # column name -> np.ndarray (strings)
    people: int = 0
    snps: int = 0

    def __post_init__(self):
        self.people = self.snparray.n
        self.snps = self.snparray.p


def _read_table(path: str, min_cols: int) -> list[list[str]]:
    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < min_cols:
                raise ValueError(f"{path}: expected >= {min_cols} columns, got {len(parts)}")
            rows.append(parts)
    return rows


def _count_lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


def _bed_payload(prefix: str):
    """Validate and read `prefix`.bed's raw payload. Returns (bed u8, n, p)."""
    bed_path, bim_path, fam_path = (prefix + s for s in (".bed", ".bim", ".fam"))
    for f in (bed_path, bim_path, fam_path):
        if not os.path.isfile(f):
            raise FileNotFoundError(f)
    p = _count_lines(bim_path)
    n = _count_lines(fam_path)
    with open(bed_path, "rb") as f:
        magic = f.read(3)
        if magic != _BED_MAGIC:
            raise ValueError(f"{bed_path}: bad magic {magic!r}; need SNP-major PLINK 1.9 .bed")
        payload = np.fromfile(f, dtype=np.uint8)
    expected = p * (-(-n // 4))
    if payload.size != expected:
        raise ValueError(f"{bed_path}: payload {payload.size} bytes, expected {expected} for n={n}, p={p}")
    return payload, n, p


def read_plink(prefix: str, dtype=None, device=None) -> SnpData:
    """Read `prefix`.bed/.bim/.fam into a :class:`SnpData` whose genotypes
    live on ``device`` (default the card) with per-SNP stats in ``dtype``
    (default float32; float64 for a float64 fit)."""
    dtype = float_dtype(torch.float32 if dtype is None else dtype,
                        "read_plink")
    bim_path, fam_path = prefix + ".bim", prefix + ".fam"
    payload, n, p = _bed_payload(prefix)
    bim = _read_table(bim_path, 6)
    fam = _read_table(fam_path, 5)
    if (len(bim), len(fam)) != (p, n):
        raise ValueError(f"{prefix}: .bim/.fam rows {(len(bim), len(fam))} "
                         f"do not match {(p, n)}")

    snparray = PackedGenotypes.from_bed_bytes(payload, n=n, p=p,
                                              device=device, dtype=dtype)

    snp_info = {
        "chromosome": np.array([r[0] for r in bim]),
        "snpid": np.array([r[1] for r in bim]),
        "genetic_distance": np.array([float(r[2]) for r in bim]),
        "position": np.array([int(r[3]) for r in bim]),
        "allele1": np.array([r[4] for r in bim]),
        "allele2": np.array([r[5] for r in bim]),
    }
    person_info = {
        "fid": np.array([r[0] for r in fam]),
        "iid": np.array([r[1] for r in fam]),
        "father": np.array([r[2] for r in fam]),
        "mother": np.array([r[3] for r in fam]),
        "sex": np.array([r[4] for r in fam]),
    }
    # phenotype columns (.fam column 6 onward), kept as strings like the
    # reference's person_info DataFrame (reference: src/wrapper.jl:170-208)
    ncols = max(len(r) for r in fam)
    for c in range(5, ncols):
        person_info[str(c + 1)] = np.array(
            [r[c] if len(r) > c else "NA" for r in fam])
    return SnpData(snparray=snparray, snp_info=snp_info, person_info=person_info)


def write_bed_payload(path: str, payload: np.ndarray) -> None:
    """Write the magic and a ``.bed`` payload (rows of ceil(n/4) bytes)."""
    with open(path, "wb") as f:
        f.write(_BED_MAGIC)
        f.write(np.ascontiguousarray(payload).tobytes())


def write_plink_bed(path: str, codes) -> None:
    """Write genotypes as `path` (.bed): an (n, p) uint8 code matrix (PLINK
    codes 0..3; the JAX package's numpy packer), or PackedGenotypes, whose
    ``.bed`` rows are made on their device ``_CHUNK_P`` SNPs at a time and
    appended, so no (n, p) code matrix is built.

    Used by the simulators (reference analog: SnpArray mmap-file creation in
    src/simulate_utilities.jl:85-101)."""
    if not isinstance(codes, PackedGenotypes):
        write_bed_payload(path, bed_payload_of_codes(np.asarray(codes).T))
        return
    with open(path, "wb") as f:
        f.write(_BED_MAGIC)
        for rows in bed_chunks(codes):
            f.write(rows.tobytes())


def merge_plink(src, des: str = "merged", dtype=None, device=None) -> SnpData:
    """Merge per-chromosome PLINK trios sharing the same samples into one
    (SnpArrays.merge_plink analog, used by the reference's UK Biobank
    pipeline: reference manuscript/UKBB_metabolomic/data_process.jl:21).

    ``src``: a filename prefix (merges every ``{src}*.bed`` trio in natural
    order: chr2 before chr10) or an explicit list of prefixes.  Writes
    ``des``.bed/.bim/.fam and returns the merged :class:`SnpData` on
    ``device`` (default the card).  `.bed` is SNP-major with
    ceil(n/4)-byte records, so merging is payload concatenation."""

    def _natural_key(prefix):
        # split trailing digit runs out of the suffix and compare them
        # numerically
        suffix = prefix[len(src):] if isinstance(src, str) else prefix
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", suffix)]

    if isinstance(src, str):
        prefixes = sorted((f[:-4] for f in glob.glob(src + "*.bed")
                           if f[:-4] != des), key=_natural_key)
        if not prefixes:
            raise FileNotFoundError(f"no {src}*.bed files to merge")
    else:
        prefixes = list(src)
    if des in prefixes:
        raise ValueError(f"merge destination {des!r} is also a merge input")

    payloads, bims = [], []
    fam0 = None
    n = None
    for pref in prefixes:
        payload, n_i, _ = _bed_payload(pref)
        with open(pref + ".fam") as f:
            fam = f.read()
        if fam0 is None:
            fam0, n = fam, n_i
        elif n_i != n or fam != fam0:
            raise ValueError(f"{pref}.fam does not match {prefixes[0]}.fam: "
                             "merge requires identical samples in order")
        payloads.append(payload)
        with open(pref + ".bim") as f:
            bims.append(f.read())

    write_bed_payload(des + ".bed", np.concatenate(payloads))
    with open(des + ".bim", "w") as f:
        for b in bims:
            f.write(b if b.endswith("\n") or not b else b + "\n")
    with open(des + ".fam", "w") as f:
        f.write(fam0)
    return read_plink(des, dtype=dtype, device=device)
