"""Parity of the port's genotype I/O, simulators and ``DenseOp`` with the
JAX package, on the CPU.

The same numpy inputs, made from seeds, go through both packages; the
files are written by the tests (the reference's example data is not
read).

Tolerances.  Exact where the work is integer or the same numpy code: the
``.bed`` repack's words byte for byte with mu / inv_sd / maf / n_missing
equal, ``read_plink``'s metadata, the ``.bed`` bytes that
``write_plink_bed`` / ``merge_plink`` / ``naive_impute`` write, the VCF and
BGEN readers' matrices (NaN where NaN), and the simulators' draws for the
same seed.  ``grm``'s float64 host loop within 1e-10 of the JAX package's
(the same sums, as there), its blocked f32 path within the 2e-5 the JAX
package's own device test allows.  ``DenseOp``'s f32 products within 1e-5
of their scale (f32 sums in another order); its gathers exactly.  Fits on
a dense x as the in-memory packed fits are held: the Gaussian fit as
``tests/test_torch_fit.py`` holds it, fits that end on a loglikelihood
plateau (logistic, warm start with debias) as
``tests/test_torch_families.py`` holds whole fits, cvs within 1e-3 (see
``tests/test_torch_wrapper.py``).
"""

import gzip
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.genotype import bgen as jbgen
from mendeliht_tpu.genotype import vcf as jvcf
from mendeliht_tpu.genotype.plink import write_plink_bed as j_write_bed
from mendeliht_tpu.ops import linalg as jlinalg

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.genotype import bgen as tbgen
from mendeliht_tpu_torch.genotype import snparray as tsnp
from mendeliht_tpu_torch.genotype import vcf as tvcf
from mendeliht_tpu_torch.ops import linalg as tlinalg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's small ops, restored
    after it (see tests/test_torch_mv.py: the default pool oversubscribes
    a host whose cores other test processes keep busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(seed, n, p, missing):
    rng = np.random.default_rng(seed)
    pr = [0.4, 0.1, 0.3, 0.2] if missing else [0.45, 0.0, 0.35, 0.2]
    return rng.choice(np.arange(4, dtype=np.uint8), size=(n, p), p=pr)


def _assert_same_genotypes(t, j):
    """The port's genotypes hold the JAX package's words byte for byte and
    its stats exactly."""
    tw, jw = t.words.numpy(), np.asarray(j.words)
    assert tw.shape == jw.shape
    assert tw.view(np.uint8).tobytes() == jw.astype("<i4").tobytes()
    np.testing.assert_array_equal(t.mu.numpy(), np.asarray(j.mu))
    np.testing.assert_array_equal(t.inv_sd.numpy(), np.asarray(j.inv_sd))
    np.testing.assert_array_equal(mt.maf(t), m.maf(j))
    np.testing.assert_array_equal(t.n_missing, j.n_missing)
    assert (t.n, t.p, t.has_missing) == (j.n, j.p, j.has_missing)


# -- the .bed repack ----------------------------------------------------------

@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("n", [200, 201, 202, 203])
def test_from_bed_bytes_matches_jax(n, missing, monkeypatch):
    """n % 4 in {0, 1, 2, 3} (the padding crumbs of each row's last byte cut
    before the counts), p % 4 == 1 (the last quad row's spare bytes zero),
    with and without missing calls; chunks of 8 SNPs (several chunks, the
    last one ragged) and the default one chunk give the same words."""
    p = 53
    codes = _codes(n + 10 * missing, n, p, missing)
    bed = tsnp.bed_payload_of_codes(codes.T).reshape(-1)
    j = m.PackedGenotypes.from_bed_bytes(bed, n, p)
    t = mt.PackedGenotypes.from_bed_bytes(bed, n, p, device="cpu")
    _assert_same_genotypes(t, j)
    assert t.has_missing == missing
    monkeypatch.setattr(tsnp, "_CHUNK_P", 8)
    t8 = mt.PackedGenotypes.from_bed_bytes(
        np.frombuffer(bed.tobytes(), np.uint8), n, p, device="cpu")
    _assert_same_genotypes(t8, j)


@pytest.mark.parametrize("n", [200, 201, 202, 203])
def test_write_plink_bed_bytes_match_jax(n, tmp_path, monkeypatch):
    """The code-matrix packer and the genotypes' chunked device packer
    (``bed_rows``, the repack's inverse; chunks of 8 SNPs, the last one
    ragged) write the JAX package's bytes."""
    codes = _codes(n, n, 37, True)
    j_write_bed(str(tmp_path / "j.bed"), codes)
    mt.write_plink_bed(str(tmp_path / "t.bed"), codes)
    monkeypatch.setattr(tsnp, "_CHUNK_P", 8)
    mt.write_plink_bed(str(tmp_path / "g.bed"),
                       mt.PackedGenotypes.from_codes(codes, device="cpu"))
    want = (tmp_path / "j.bed").read_bytes()
    assert (tmp_path / "t.bed").read_bytes() == want
    assert (tmp_path / "g.bed").read_bytes() == want


def _trio(tmp_path, name, n, p, seed, traits=1):
    """A PLINK trio from the JAX simulator; returns the prefix and y."""
    rng = np.random.default_rng(seed)
    pref = str(tmp_path / name)
    x, _ = m.simulate_random_snparray(pref + ".bed", n, p, rng=rng)
    y = rng.standard_normal((n, traits) if traits > 1 else n)
    m.make_bim_fam_files(x, y, pref)
    return pref, y


def test_read_plink_matches_jax(tmp_path):
    pref, _ = _trio(tmp_path, "a", 61, 29, 3, traits=2)
    j = m.read_plink(pref)
    t = mt.read_plink(pref, device="cpu")
    assert (t.people, t.snps) == (j.people, j.snps) == (61, 29)
    _assert_same_genotypes(t.snparray, j.snparray)
    assert t.snp_info.keys() == j.snp_info.keys()
    for key in j.snp_info:
        np.testing.assert_array_equal(t.snp_info[key], j.snp_info[key])
    assert list(t.person_info) == list(j.person_info)
    for key in j.person_info:
        np.testing.assert_array_equal(t.person_info[key], j.person_info[key])
    t64 = mt.read_plink(pref, dtype=torch.float64, device="cpu")
    assert t64.snparray.mu.dtype == torch.float64
    np.testing.assert_array_equal(t64.snparray.words, t.snparray.words)


def test_read_plink_errors_match_jax(tmp_path):
    pref, _ = _trio(tmp_path, "e", 20, 8, 4)
    bed = (tmp_path / "e.bed").read_bytes()
    for bad, body in (("magic", b"\x00" + bed[1:]), ("size", bed[:-1])):
        (tmp_path / "e.bed").write_bytes(body)
        with pytest.raises(ValueError) as ej:
            m.read_plink(pref)
        with pytest.raises(ValueError) as et:
            mt.read_plink(pref, device="cpu")
        assert str(et.value) == str(ej.value), bad
    with pytest.raises(FileNotFoundError):
        mt.read_plink(str(tmp_path / "absent"), device="cpu")


def test_read_plink_needs_a_device(tmp_path, monkeypatch):
    """No CUDA device and no device given: raise, never fall back to the
    CPU."""
    pref, _ = _trio(tmp_path, "d", 20, 8, 5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.read_plink(pref)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.simulate_random_snparray(None, 20, 8,
                                    rng=np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlinalg.make_operator(np.zeros((4, 3)))


def test_merge_plink_matches_jax(tmp_path):
    """Natural order (chr2 before chr10), the destination excluded on a
    re-run, the same bytes and genotypes as the JAX package's merge, and
    its errors."""
    n = 20
    y = np.random.default_rng(6).standard_normal(n)
    for c in (1, 2, 10):
        pref = str(tmp_path / f"chr{c}")
        x, _ = m.simulate_random_snparray(pref + ".bed", n, 6 + c,
                                          rng=np.random.default_rng(c))
        m.make_bim_fam_files(x, y, pref)
    src = str(tmp_path / "chr")
    j = m.merge_plink(src, des=str(tmp_path / "jall"))
    for _ in range(2):          # the second run sees its own output
        t = mt.merge_plink(src, des=str(tmp_path / "chr_all"),
                           device="cpu")
        _assert_same_genotypes(t.snparray, j.snparray)
    for ext in (".bed", ".bim", ".fam"):
        assert ((tmp_path / f"chr_all{ext}").read_bytes()
                == (tmp_path / f"jall{ext}").read_bytes())
    with pytest.raises(ValueError, match="also a merge input"):
        mt.merge_plink([src + "1"], des=src + "1", device="cpu")
    x3, _ = m.simulate_random_snparray(str(tmp_path / "o.bed"), n + 4, 7,
                                       rng=np.random.default_rng(9))
    m.make_bim_fam_files(x3, np.zeros(n + 4), str(tmp_path / "o"))
    with pytest.raises(ValueError, match="does not match"):
        mt.merge_plink([src + "1", str(tmp_path / "o")],
                       des=str(tmp_path / "bad"), device="cpu")
    with pytest.raises(FileNotFoundError):
        mt.merge_plink(str(tmp_path / "zz"), device="cpu")


def test_naive_impute_matches_jax(tmp_path, monkeypatch):
    """The mode's code fills each missing call (ties as the reference's
    if/elseif chain); chunked over SNPs, the same codes, stats and written
    ``.bed`` as the JAX package's."""
    codes = _codes(11, 83, 41, True)
    codes[:, 0] = [0, 2, 1] * 27 + [0, 2]           # a 0/2 tie
    codes[:, 1] = [2, 3, 1] * 27 + [2, 3]           # a 2/3 tie
    j = m.naive_impute(m.PackedGenotypes.from_codes(codes),
                       str(tmp_path / "j.bed"))
    monkeypatch.setattr(tsnp, "_CHUNK_P", 8)
    t = mt.naive_impute(mt.PackedGenotypes.from_codes(codes, device="cpu"),
                        str(tmp_path / "t.bed"))
    _assert_same_genotypes(t, j)
    assert not t.has_missing
    np.testing.assert_array_equal(t.to_codes(), j.to_codes())
    assert (tmp_path / "t.bed").read_bytes() == (tmp_path / "j.bed").read_bytes()


def test_grm_matches_jax():
    """grm's float64 host loop (``device=False``, and the default on CPU
    genotypes) within 1e-10 of the JAX package's; the blocked path
    (``device=True``, run here on the CPU) within 2e-5, with missing calls
    and a ragged last chunk."""
    codes = _codes(12, 70, 53, True)
    j = m.PackedGenotypes.from_codes(codes)
    t = mt.PackedGenotypes.from_codes(codes, device="cpu")
    want = m.grm(j, device=False)
    for got in (mt.grm(t), mt.grm(t, device=False, chunk=16)):
        assert got.shape == (70, 70) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(mt.grm(t, device=True, chunk=16), want,
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="unsupported GRM method"):
        mt.grm(t, method="other")


# -- VCF and BGEN -------------------------------------------------------------

_GT = np.array(["0/0", "./.", "0/1", "1/1"])


def _write_vcf(path, cells, fmt="GT", opener=open):
    """A VCF of the (p, n) cell strings."""
    p, n = cells.shape
    with opener(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n)) + "\n")
        for j in range(p):
            f.write(f"{1 + j % 3}\t{100 * (j + 1)}\trs{j}\tA\tG\t.\tPASS\t.\t"
                    f"{fmt}\t" + "\t".join(cells[j]) + "\n")


def _same_read(got, want):
    for g, w in zip(got, want):
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(g, w)       # NaN where NaN
        else:
            assert g.tolist() == w.tolist()


@pytest.mark.parametrize("gz", [False, True])
def test_read_vcf_gt_matches_jax(tmp_path, gz):
    """GT cells on the vectorized fast path, and rows on the per-cell slow
    path: haploid and multi-allelic calls, a ':'-suffixed field, GT not
    first in FORMAT."""
    cells = _GT[_codes(13, 40, 12, True).T]
    cells = cells.astype(object)
    cells[3, :4] = ["1", "0", "0|1", "./1"]            # haploid, half-missing
    cells[5, :3] = ["0/2", "10/0", "1|1:35"]            # multi-allelic
    path = str(tmp_path / ("x.vcf.gz" if gz else "x.vcf"))
    _write_vcf(path, cells.astype(str), opener=gzip.open if gz else open)
    _same_read(tvcf.read_vcf(path), jvcf.read_vcf(path))
    # GT second in FORMAT: every cell through the slow path
    cells2 = np.char.add("9:", _GT[_codes(14, 30, 6, True).T])
    _write_vcf(str(tmp_path / "y.vcf"), cells2, fmt="DP:GT")
    _same_read(tvcf.read_vcf(str(tmp_path / "y.vcf")),
               jvcf.read_vcf(str(tmp_path / "y.vcf")))


def test_read_vcf_ds_and_errors_match_jax(tmp_path):
    rng = np.random.default_rng(15)
    ds = np.round(rng.uniform(0, 2, size=(9, 25)), 3).astype(str)
    ds[2, :3] = [".", "", "1.5:0.2"]
    _write_vcf(str(tmp_path / "d.vcf"), ds, fmt="DS")
    _same_read(tvcf.read_vcf(str(tmp_path / "d.vcf"), dosage=True),
               jvcf.read_vcf(str(tmp_path / "d.vcf"), dosage=True))
    _write_vcf(str(tmp_path / "k.vcf"), np.char.add("0.5:", ds), fmt="GP:DS")
    _same_read(tvcf.read_vcf(str(tmp_path / "k.vcf"), dosage=True),
               jvcf.read_vcf(str(tmp_path / "k.vcf"), dosage=True))
    for path, kw in (("d.vcf", {}), ("k.vcf", {})):      # no GT field
        with pytest.raises(ValueError) as ej:
            jvcf.read_vcf(str(tmp_path / path), **kw)
        with pytest.raises(ValueError) as et:
            tvcf.read_vcf(str(tmp_path / path), **kw)
        assert str(et.value) == str(ej.value)


def _vstr(s):
    b = s.encode()
    return struct.pack("<H", len(b)) + b


def _bgen(path, variants, ns, compression, compress=None, phased=0):
    """The synthetic layout-2 BGEN writer of tests/test_genotype.py:
    ``variants`` (chrom, pos, rsid, ref, alt, probs (ns, 2) 8-bit, missing
    (ns,)); ``compression`` 0 (none), 1 (zlib) or 2 (zstd) with its
    ``compress`` function."""
    body = b""
    for chrom, pos, rsid, ref, alt, probs, miss in variants:
        body += _vstr("v_" + rsid) + _vstr(rsid) + _vstr(chrom)
        body += struct.pack("<I", pos) + struct.pack("<H", 2)
        for a in (ref, alt):
            body += struct.pack("<I", len(a)) + a.encode()
        ploidy = bytes((2 | (0x80 if mi else 0)) for mi in miss)
        raw = (struct.pack("<IH", ns, 2) + bytes([2, 2]) + ploidy
               + bytes([phased, 8]) + b"".join(bytes(p) for p in probs))
        if compression:
            comp = compress(raw)
            body += struct.pack("<I", len(comp) + 4) + struct.pack("<I", len(raw))
            body += comp
        else:
            body += struct.pack("<I", len(raw)) + raw
    flags = compression | (2 << 2)
    header = struct.pack("<IIII4sI", 20, 20, len(variants), ns, b"bgen",
                         flags)
    with open(path, "wb") as f:
        f.write(header + body)


def _variants(seed, nv, ns):
    rng = np.random.default_rng(seed)
    out = []
    for v in range(nv):
        probs = rng.integers(0, 128, size=(ns, 2)).tolist()
        miss = (rng.random(ns) < 0.1).tolist()
        out.append((str(1 + v % 2), 100 * (v + 1), f"rs{v}", "A", "G", probs,
                    miss))
    return out


@pytest.mark.parametrize("kind", ["none", "zlib", "zstd", "phased"])
def test_read_bgen_matches_jax(tmp_path, kind):
    ns = 7
    variants = _variants(16, 5, ns)
    path = str(tmp_path / "x.bgen")
    if kind == "zstd":
        zstd = pytest.importorskip("zstandard")
        _bgen(path, variants, ns, 2, zstd.ZstdCompressor().compress)
    elif kind == "zlib":
        _bgen(path, variants, ns, 1, zlib.compress)
    else:
        _bgen(path, variants, ns, 0, phased=int(kind == "phased"))
    got, want = tbgen.read_bgen(path), jbgen.read_bgen(path)
    assert got[0].shape == (ns, 5)
    _same_read(got, want)


# -- the simulators -----------------------------------------------------------

def test_simulate_random_snparray_matches_jax(tmp_path):
    """The same draws for the same seed: genotypes, mafs, the written
    ``.bed``; with fixed mafs too; and the JAX package's errors."""
    for kw in ({}, {"mafs": np.linspace(0.05, 0.5, 30)}):
        j, jm = m.simulate_random_snparray(str(tmp_path / "j.bed"), 50, 30,
                                           rng=np.random.default_rng(17),
                                           **kw)
        t, tm = mt.simulate_random_snparray(str(tmp_path / "t.bed"), 50, 30,
                                            rng=np.random.default_rng(17),
                                            device="cpu", **kw)
        _assert_same_genotypes(t, j)
        np.testing.assert_array_equal(tm, jm)
        assert (tmp_path / "t.bed").read_bytes() == (tmp_path / "j.bed").read_bytes()
    with pytest.raises(ValueError, match="not in"):
        mt.simulate_random_snparray(None, 5, 2, mafs=[0.7, 0.1], device="cpu")


def test_simulate_correlated_snparray_matches_jax():
    j = m.simulate_correlated_snparray(None, 40, 60, block_length=20,
                                       rng=np.random.default_rng(18))
    t = mt.simulate_correlated_snparray(None, 40, 60, block_length=20,
                                        rng=np.random.default_rng(18),
                                        device="cpu")
    _assert_same_genotypes(t, j)
    for kw in ({"block_length": 7}, {"prob": 1.0}):
        with pytest.raises(ValueError) as ej:
            m.simulate_correlated_snparray(None, 40, 60, **kw)
        with pytest.raises(ValueError) as et:
            mt.simulate_correlated_snparray(None, 40, 60, device="cpu", **kw)
        assert str(et.value) == str(ej.value)


def test_make_snparray_and_correlation_match_jax(tmp_path):
    rng = np.random.default_rng(19)
    vals = rng.choice([0.0, 1.0, 2.0, np.nan], size=(40, 25),
                      p=[0.4, 0.3, 0.2, 0.1])
    j = m.make_snparray(str(tmp_path / "j.bed"), vals)
    t = mt.make_snparray(str(tmp_path / "t.bed"), vals, device="cpu")
    _assert_same_genotypes(t, j)
    assert (tmp_path / "t.bed").read_bytes() == (tmp_path / "j.bed").read_bytes()
    ints = np.nan_to_num(vals).astype(np.int64)
    _assert_same_genotypes(mt.make_snparray(None, ints, device="cpu"),
                           m.make_snparray(None, ints))
    codes = j.to_codes()
    cj = m.adhoc_add_correlation(codes.copy(), 0.6, 2, [5, 7],
                                 rng=np.random.default_rng(20))
    ct = mt.adhoc_add_correlation(codes.copy(), 0.6, 2, [5, 7],
                                  rng=np.random.default_rng(20))
    np.testing.assert_array_equal(ct, cj)
    with pytest.raises(ValueError, match="correlation coefficient"):
        mt.adhoc_add_correlation(codes, 1.5, 2, 5)


@pytest.mark.parametrize("traits", [1, 3])
def test_make_bim_fam_files_match_jax(tmp_path, traits):
    """The same ``.bim`` / ``.fam`` bytes from genotypes, a dense matrix or
    a tensor; a float32 y reads back as the same float32."""
    rng = np.random.default_rng(21)
    g = mt.PackedGenotypes.from_codes(_codes(21, 30, 9, False), device="cpu")
    y = rng.standard_normal((30, traits) if traits > 1 else 30)
    m.make_bim_fam_files(np.zeros((30, 9)), y, str(tmp_path / "j"))
    for i, x in enumerate((g, np.zeros((30, 9)), torch.zeros(30, 9))):
        mt.make_bim_fam_files(x, y, str(tmp_path / f"t{i}"))
        for ext in (".bim", ".fam"):
            assert ((tmp_path / f"t{i}{ext}").read_bytes()
                    == (tmp_path / f"j{ext}").read_bytes())
    y32 = y.astype(np.float32)
    mt.make_bim_fam_files(g, y32, str(tmp_path / "f"))
    fam = np.loadtxt(str(tmp_path / "f.fam"), ndmin=2)[:, 5:]
    np.testing.assert_array_equal(fam.astype(np.float32),
                                  y32.reshape(30, traits))
    with pytest.raises(ValueError, match="phenotype has length"):
        mt.make_bim_fam_files(g, y[:-1], str(tmp_path / "bad"))


def test_standardize_matches_jax():
    z = np.random.default_rng(22).standard_normal((30, 3)) * [1, 5, 0]
    np.testing.assert_array_equal(mt.standardize(z.copy()),
                                  m.standardize(z.copy()))


# -- DenseOp --------------------------------------------------------------------

def _close(got, want, tol=1e-5):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(23)
    X = rng.standard_normal((90, 70)).astype(np.float32)
    B, S, R = 3, 6, 2
    idx = rng.integers(0, 70, size=(B, S)).astype(np.int32)
    coef = rng.standard_normal((B, S)).astype(np.float32)
    coefm = rng.standard_normal((B, R, S)).astype(np.float32)
    valid = (rng.random((B, S)) < 0.7).astype(np.float32)
    W = (rng.random((B, 90)) < 0.8).astype(np.float32)
    WY = (W * rng.standard_normal(90)).astype(np.float32)
    Rm = rng.standard_normal((B, 90)).astype(np.float32)
    return X, idx, coef, coefm, valid, W, WY, Rm


@pytest.mark.parametrize("gather_bytes", [None, 1])
def test_dense_op_matches_jax(dense, gather_bytes, monkeypatch):
    """Every DenseOp method against the JAX package's; the forward products
    in one chunk of tasks or one task a chunk."""
    X, idx, coef, coefm, valid, W, WY, Rm = dense
    if gather_bytes:
        monkeypatch.setattr(tlinalg, "_GATHER_BYTES", gather_bytes)
    j = jlinalg.DenseOp(jnp.asarray(X))
    t = tlinalg.make_operator(torch.from_numpy(X.astype(np.float64)))
    assert isinstance(t, tlinalg.DenseOp) and t.dtype == torch.float32
    assert (t.n, t.p, t.n_pad) == (90, 70, 90)
    T = torch.from_numpy
    ti = T(idx).long()
    _close(t.xtr(T(Rm)), j.xtr(jnp.asarray(Rm)))
    _close(t.forward_sel(ti, T(coef), T(valid)),
           j.forward_sel(idx, coef, valid))
    _close(t.forward_sel_multi(ti, T(coefm), T(valid)),
           j.forward_sel_multi(idx, coefm, valid))
    np.testing.assert_array_equal(t.gather_cols(ti, T(valid)).numpy(),
                                  np.asarray(j.gather_cols(idx, valid)))
    for a, b in zip(t.col_moments(T(W), T(WY)), j.col_moments(W, WY)):
        _close(a, b)
    assert tlinalg.make_operator(t) is t


def test_full_f32_restores_the_callers_precision():
    """Inside ``full_f32`` cuBLAS and oneDNN run f32 products in full f32;
    after it, whatever the caller had set is back."""
    backends = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    before = [b.fp32_precision for b in backends]
    try:
        torch.set_float32_matmul_precision("high")
        outer = [b.fp32_precision for b in backends]
        with tlinalg.full_f32():
            assert [b.fp32_precision for b in backends] == ["ieee", "ieee"]
        assert [b.fp32_precision for b in backends] == outer
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        for b, o in zip(backends, before):
            b.fp32_precision = o


# -- the solver on a dense x ----------------------------------------------------

@pytest.fixture(scope="module")
def dense_problem():
    """A standardized dense matrix (missing calls imputed), an intercept and
    a covariate, and Gaussian, Bernoulli and two-trait responses over five
    causal columns with distinct effects."""
    rng = np.random.default_rng(24)
    n, p = 300, 500
    codes = rng.choice(np.arange(4, dtype=np.uint8), size=(n, p),
                       p=[0.45, 0.05, 0.3, 0.2])
    X = m.PackedGenotypes.from_codes(codes).to_dense_standardized()
    causal = rng.choice(p, 5, replace=False)
    eta = X[:, causal] @ np.array([1.0, -0.8, 0.6, -1.2, 0.9])
    cov = rng.standard_normal(n)
    z = np.stack([np.ones(n), cov], axis=1)
    y = eta + 0.5 * cov + 1.0 + rng.standard_normal(n)
    yb = (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    Y = np.stack([y, 0.5 * eta + rng.standard_normal(n)])
    return X, z, y, yb, Y


def _whole_fits_agree(rt, rj, exact):
    """``exact``: as tests/test_torch_fit.py holds a Gaussian fit (the same
    iterations, beta and c within 1e-4 of max|beta|); else as
    tests/test_torch_families.py holds a whole fit that ends on a
    loglikelihood plateau (iterations within 3, 2e-3)."""
    assert set(np.flatnonzero(rt.beta)) == set(np.flatnonzero(rj.beta))
    tol = 1e-4 if exact else 2e-3
    assert (rt.iter == rj.iter) if exact else abs(rt.iter - rj.iter) <= 3
    scale = np.abs(rj.beta).max()
    assert np.abs(rt.beta - rj.beta).max() <= tol * scale
    assert np.abs(rt.c - rj.c).max() <= tol * max(scale, 1.0)
    assert abs(rt.logl - rj.logl) <= 1e-4 * abs(rj.logl)


DENSE_FITS = {
    "normal": (dict(), True),
    "bernoulli": (dict(d="Bernoulli"), False),
    "init_beta-debias": (dict(init_beta=True, debias=True), False),
}


@pytest.mark.parametrize("case", list(DENSE_FITS))
def test_dense_fit_matches_jax(dense_problem, case):
    """fit_iht on a dense x (a CPU tensor keeps its device): the Gaussian
    fit, the logistic fit and the Gaussian fit with the warm start
    (``DenseOp.col_moments``) and the debias refit (``gather_cols``),
    against the JAX package's ``DenseOp`` fits."""
    X, z, y, yb, _ = dense_problem
    kw, exact = DENSE_FITS[case]
    kw = dict(kw)
    d = kw.pop("d", "Normal")
    resp = yb if d == "Bernoulli" else y
    rj = m.fit_iht(resp, X, z, k=5, d=getattr(m, d)(), verbose=False, **kw)
    rt = mt.fit_iht(resp, torch.from_numpy(X), z, k=5, d=getattr(mt, d)(),
                    verbose=False, **kw)
    _whole_fits_agree(rt, rj, exact)


@pytest.mark.parametrize("d", ["Normal", "Bernoulli", "MvNormal"])
def test_dense_cv_matches_jax(dense_problem, d):
    """cv_iht on a dense x against the JAX package's: mse within 1e-3
    relative (its tasks are whole fits on a plateau:
    tests/test_torch_wrapper.py), the same best k."""
    X, z, y, yb, Y = dense_problem
    resp = {"Normal": y, "Bernoulli": yb, "MvNormal": Y}[d]
    zz = z.T if d == "MvNormal" else z
    kw = dict(path=[2, 4, 5, 6, 8], q=3, verbose=False,
              folds=np.tile([1, 2, 3], 100))
    mj = m.cv_iht(resp, X, zz, d=getattr(m, d)(), **kw)
    mt_ = mt.cv_iht(resp, torch.from_numpy(X), zz, d=getattr(mt, d)(), **kw)
    assert np.max(np.abs(mt_ - mj) / np.abs(mj)) < 1e-3
    assert int(np.argmin(mt_)) == int(np.argmin(mj))


def test_simulate_random_response_on_a_tensor_matches_jax(dense_problem):
    """The simulator's draws from a dense tensor x equal the JAX package's
    from the same matrix in numpy (the causal columns' float64 products,
    within 1e-12); ``pve`` of a tensor within the 1e-6 relative that
    tests/test_torch_options.py holds it to (the JAX package's inverse
    link runs in f32)."""
    X = dense_problem[0]
    j = m.simulate_random_response(X, 4, m.Poisson(),
                                   rng=np.random.default_rng(25))
    t = mt.simulate_random_response(torch.from_numpy(X), 4, mt.Poisson(),
                                    rng=np.random.default_rng(25))
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-12)
    Xt = torch.from_numpy(X)
    pj = m.pve(j[0], X, j[1], l=m.LogLink())
    pt = mt.pve(t[0], Xt, t[1], l=mt.LogLink())
    assert pt == pytest.approx(pj, rel=1e-6)
