"""Parity of the port's file-level API (``iht`` / ``cross_validate`` and the
parsers of ``utils/wrapper.py``) with the JAX package's, on the CPU
(``device="cpu"``).

Every file is written here from seeded numpy draws: a PLINK trio of the JAX
simulator's genotypes with y in ``.fam`` column 6, the same y as comma- and
whitespace-separated phenotype files, a covariate file, a VCF (GT) of the
same genotypes, and a two-trait trio.  A PLINK fit runs on packed
genotypes, a VCF fit on a dense f32 matrix (``DenseOp``).

Tolerances.  A whole fit ends on a loglikelihood plateau, where ties
between f32 sums decide which iterate is best and when the fit stops (a
torch thread count alone moves this module's PLINK fit by 4e-4 of max|beta|
with the same backtracks): univariate fits are held as
``tests/test_torch_families.py`` holds whole fits, to the same support,
iterations within 3, beta and c within 2e-3 of max|beta| (the spread
between the JAX package's own two solve loops) and logl within 1e-4
relative; the multivariate fit as ``tests/test_torch_mv.py`` does, to the
same (trait, SNP) support, iterations within one and B, Sigma within 5e-4
of their max.  A cv's tasks are such fits: on this module's PLINK cv one
task stops at iteration 11 in the port and 12 in the JAX package (with any
torch thread count; the JAX package's two cv solve paths agree exactly with
each other, as the port's do), which moves the mse by 1.2e-4 relative, so
the cv mse is held within 1e-3 relative, the best k exactly. Two port fits
of one y read from ``.fam`` and from phenotype files are held to 1e-6, as
``tests/test_wrapper.py`` holds the JAX package's.  The beta file is
parsed: its header and variant columns exactly, its betas as the result's
(each written by ``str``, so it reads back as the same float32).  The
summary files equal the JAX package's line for line with every number
masked and runs of spaces joined (the numbers are the results held above,
and the compute time).  The parsers, which are the JAX package's numpy
code, give its values exactly, and its errors word for word.
"""

import contextlib
import io
import re
import shutil
import struct

import numpy as np
import pytest
import torch

import mendeliht_tpu as m
from mendeliht_tpu.utils import wrapper as jw

import mendeliht_tpu_torch as mt
from mendeliht_tpu_torch.utils import wrapper as tw

N, P, K = 200, 300, 3
CV_PATH = [1, 2, 3, 4, 5]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module's small ops, restored
    after it (see tests/test_torch_mv.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_vcf(path, codes):
    """A GT VCF of (n, p) PLINK codes."""
    gt = np.array(["0/0", "./.", "0/1", "1/1"])[codes.T]
    n = codes.shape[0]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n)) + "\n")
        for j, row in enumerate(gt):
            f.write(f"1\t{100 * (j + 1)}\tsnp{j + 1}\t1\t2\t.\tPASS\t.\tGT\t"
                    + "\t".join(row) + "\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wrapper")
    rng = np.random.default_rng(31)
    x, _ = m.simulate_random_snparray(str(d / "w.bed"), N, P, rng=rng)
    y, _, _ = m.simulate_random_response(x, K, m.Normal(), rng=rng)
    m.make_bim_fam_files(x, y, str(d / "w"))
    np.savetxt(d / "w.phen", y.reshape(-1, 1), delimiter=",")
    np.savetxt(d / "w_ws.phen", y.reshape(-1, 1), delimiter=" ")
    z = np.column_stack([np.ones(N), rng.standard_normal(N) * 3 + 1])
    np.savetxt(d / "cov.csv", z, delimiter=",")
    _write_vcf(str(d / "w.vcf"), x.to_codes())
    Y, _, _, _ = m.simulate_random_multivariate_response(
        x, 4, 2, overlap=1, rng=np.random.default_rng(32))
    shutil.copy(d / "w.bed", d / "mv.bed")
    m.make_bim_fam_files(x, Y, str(d / "mv"))
    return d


def _masked(path):
    """The file's lines with every number masked and runs of spaces
    joined."""
    with open(path) as f:
        return [re.sub(r" +", " ", re.sub(r"[-+]?\d[\d.eE+-]*", "#", ln))
                for ln in f]


def _beta_file(path, traits=1):
    """(header, variant columns, betas) of a beta file."""
    with open(path) as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    body = np.array(rows[1:], dtype=object)
    return rows[0], body[:, :5].tolist(), body[:, 5:5 + traits].astype(float)


def _pair(files, name, fn_name, *args, seed=None, **kw):
    """Run the JAX package's and the port's ``fn_name`` on the same files,
    each writing its own output files (prefix ``j_`` / ``t_``); a cv draws
    its folds from ``default_rng(seed)``, one for each."""
    out = {}
    for tag, mod in (("j", m), ("t", mt)):
        kws = dict(kw)
        if seed is not None:
            kws["rng"] = np.random.default_rng(seed)
        if fn_name == "iht":
            kws.update(summaryfile=str(files / f"{tag}_{name}.summary"),
                       betafile=str(files / f"{tag}_{name}.beta"),
                       covariancefile=str(files / f"{tag}_{name}.cov"))
        else:
            kws["cv_summaryfile"] = str(files / f"{tag}_{name}.cvsummary")
        if tag == "t":
            kws["device"] = "cpu"
        d = getattr(mod, kws.pop("d"))
        out[tag] = getattr(mod, fn_name)(*args, d, **kws)
    return out["j"], out["t"]


def _same_fit(t, j):
    assert set(np.flatnonzero(t.beta)) == set(np.flatnonzero(j.beta))
    assert abs(t.iter - j.iter) <= 3
    scale = np.abs(j.beta).max()
    assert np.abs(t.beta - j.beta).max() <= 2e-3 * scale
    assert np.abs(t.c - j.c).max() <= 2e-3 * scale
    assert abs(t.logl - j.logl) <= 1e-4 * abs(j.logl)


def _same_files(files, name, traits=1):
    for ext in ("summary",):
        assert (_masked(files / f"t_{name}.{ext}")
                == _masked(files / f"j_{name}.{ext}"))
    th, tv, tb = _beta_file(files / f"t_{name}.beta", traits)
    jh, jv, jb = _beta_file(files / f"j_{name}.beta", traits)
    assert th == jh and tv == jv and len(tv) == P
    return tb, jb


@pytest.fixture(scope="module")
def plink_fits(files):
    return {
        "fam": _pair(files, "fam", "iht", str(files / "w"), K, d="Normal",
                     verbose=False),
        "cov": _pair(files, "cov", "iht", str(files / "w"), K, d="Normal",
                     phenotypes=str(files / "w.phen"),
                     covariates=str(files / "cov.csv"), verbose=False),
    }


@pytest.mark.parametrize("case", ["fam", "cov"])
def test_iht_plink_matches_jax(files, plink_fits, case):
    """iht on the PLINK trio, y from ``.fam`` column 6 or a phenotype file
    with a covariate file: the JAX package's fit, beta file and summary;
    the beta file not empty (the reference's wrapper.jl:117 bug stays
    unreplicated)."""
    j, t = plink_fits[case]
    assert isinstance(t, mt.IHTResult)
    _same_fit(t, j)
    tb, jb = _same_files(files, case)
    np.testing.assert_array_equal(tb[:, 0].astype(np.float32), t.beta)
    assert np.count_nonzero(tb) == K
    assert np.abs(tb - jb).max() <= 2e-3 * np.abs(jb).max()
    assert t.c.shape == ((2,) if case == "cov" else (1,))


def test_iht_phenotype_sources_agree(files, plink_fits):
    """.fam column 6, a comma-separated and a whitespace-separated
    phenotype file give one fit."""
    a = plink_fits["fam"][1]
    for phen in ("w.phen", "w_ws.phen"):
        b = mt.iht(str(files / "w"), K, mt.Normal,
                   phenotypes=str(files / phen), device="cpu",
                   summaryfile=str(files / "s.txt"),
                   betafile=str(files / "b.txt"), verbose=False)
        np.testing.assert_allclose(b.beta, a.beta, atol=1e-6)
        np.testing.assert_allclose(b.c, a.c, atol=1e-6)
        assert b.iter == a.iter


def test_cross_validate_plink_matches_jax(files):
    j, t = _pair(files, "cv", "cross_validate", str(files / "w"), d="Normal",
                 path=CV_PATH, q=3, verbose=False, seed=33)
    assert np.max(np.abs(t - j) / np.abs(j)) < 1e-3
    assert CV_PATH[int(np.argmin(t))] == CV_PATH[int(np.argmin(j))]
    tl = _masked(files / "t_cv.cvsummary")
    jl = _masked(files / "j_cv.cvsummary")
    assert tl == jl
    with open(files / "t_cv.cvsummary") as f:
        table = [ln.split() for ln in f if re.match(r"\s*\d+\t", ln)]
    assert [int(r[0]) for r in table] == CV_PATH


@pytest.fixture(scope="module")
def vcf_fits(files):
    return _pair(files, "vcf", "iht", str(files / "w.vcf"), K, d="Normal",
                 phenotypes=str(files / "w.phen"), verbose=False)


def test_iht_vcf_matches_jax(files, vcf_fits):
    """The VCF path: the JAX package's standardized matrix exactly, within
    1e-12 of the PLINK trio's (stats in float64), and its dense fit."""
    Xj, *mj = jw.parse_genotypes(str(files / "w.vcf"))
    Xt, *mt_ = tw.parse_genotypes(str(files / "w.vcf"), device="cpu")
    np.testing.assert_array_equal(Xt, Xj)
    for a, b in zip(mt_, mj):
        assert a.tolist() == b.tolist()
    plink = mt.read_plink(str(files / "w"), dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(Xt, plink.snparray.to_dense_standardized(),
                               rtol=0, atol=1e-12)
    j, t = vcf_fits
    _same_fit(t, j)
    tb, jb = _same_files(files, "vcf")
    assert np.abs(tb - jb).max() <= 2e-3 * np.abs(jb).max()
    # the same y through the packed genotypes selects the same SNPs
    packed = mt.iht(str(files / "w"), K, mt.Normal,
                    phenotypes=str(files / "w.phen"), device="cpu",
                    summaryfile=str(files / "p.txt"),
                    betafile=str(files / "pb.txt"), verbose=False)
    assert set(np.flatnonzero(t.beta)) == set(np.flatnonzero(packed.beta))


def test_cross_validate_vcf_matches_jax(files):
    j, t = _pair(files, "cvv", "cross_validate", str(files / "w.vcf"),
                 d="Normal", path=CV_PATH, q=3,
                 phenotypes=str(files / "w.phen"), verbose=False, seed=34)
    assert np.max(np.abs(t - j) / np.abs(j)) < 1e-3
    assert CV_PATH[int(np.argmin(t))] == CV_PATH[int(np.argmin(j))]


def test_iht_multivariate_matches_jax(files):
    """.fam columns 6 and 7 as two traits: the covariance file is written,
    the beta file has a column a trait, the fit is the JAX package's."""
    j, t = _pair(files, "mv", "iht", str(files / "mv"), 4, d="MvNormal",
                 phenotypes=[6, 7], verbose=False)
    assert isinstance(t, mt.MIHTResult) and t.traits == 2
    assert ({tuple(e) for e in np.argwhere(t.beta)}
            == {tuple(e) for e in np.argwhere(j.beta)})
    assert abs(t.iter - j.iter) <= 1
    for a, b in ((t.beta, j.beta), (t.Sigma, j.Sigma)):
        assert np.abs(a - b).max() <= 5e-4 * np.abs(b).max()
    np.testing.assert_allclose(np.loadtxt(files / "t_mv.cov"), t.Sigma,
                               rtol=1e-7)
    tb, _ = _same_files(files, "mv", traits=2)
    th, _, _ = _beta_file(files / "t_mv.beta", 2)
    assert th[5:] == ["beta_1", "beta_2"]
    np.testing.assert_allclose(tb.T, t.beta, rtol=1e-7)


def test_cross_validate_multivariate_matches_jax(files):
    j, t = _pair(files, "cvmv", "cross_validate", str(files / "mv"),
                 d="MvNormal", phenotypes=[6, 7], path=[2, 4], q=3,
                 verbose=False, seed=35)
    assert len(t) == 2 and np.all(t > 0)
    assert np.max(np.abs(t - j) / np.abs(j)) < 1e-3


def test_summary_tees_verbose_lines(files, capsys):
    """verbose iht tees the signature, the parameter banner and the
    per-iteration lines into the summary file before the result block, as
    the JAX package does; the lines also go to stdout."""
    mt.iht(str(files / "w"), K, mt.Normal, device="cpu",
           summaryfile=str(files / "v.txt"), betafile=str(files / "vb.txt"),
           verbose=True)
    text = (files / "v.txt").read_text()
    assert "mendeliht_tpu_torch" in text
    assert f"Sparsity parameter (k) = {K}" in text
    assert "Iteration 1: loglikelihood = " in text
    assert f"IHT estimated {K} nonzero SNP predictors" in text
    assert "Iteration 1: loglikelihood = " in capsys.readouterr().out


def test_parsers_sniff_delimiters_as_jax(files):
    """Comma-, tab- and whitespace-separated phenotype and covariate files
    parse to the JAX package's values, exactly."""
    rng = np.random.default_rng(36)
    Y = rng.standard_normal((40, 2))
    Z = np.column_stack([np.ones(40), rng.standard_normal((40, 2)) * 4 + 2])
    for name, dl in (("csv", ","), ("tsv", "\t"), ("txt", " ")):
        np.savetxt(files / f"y.{name}", Y, delimiter=dl)
        np.savetxt(files / f"z.{name}", Z, delimiter=dl)
        for d in ("MvNormal", "Normal"):
            path = str(files / f"y.{name}")
            np.testing.assert_array_equal(
                tw.parse_phenotypes(None, path, getattr(mt, d)()),
                jw.parse_phenotypes(None, path, getattr(m, d)()))
        for ex in ((), (3,), np.array([False, True, False])):
            path = str(files / f"z.{name}")
            np.testing.assert_array_equal(tw.parse_covariates(path, ex),
                                          jw.parse_covariates(path, ex))
    np.savetxt(files / "u.phen", Y[:, 0])
    np.testing.assert_array_equal(
        tw.parse_phenotypes(None, str(files / "u.phen"), mt.Normal()),
        jw.parse_phenotypes(None, str(files / "u.phen"), m.Normal()))
    np.testing.assert_array_equal(
        tw.parse_covariates(str(files / "z.csv"), standardize=False),
        jw.parse_covariates(str(files / "z.csv"), standardize=False))


def _stderr(fn, *args, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args, **kw)
    return out, err.getvalue()


def test_parser_errors_and_warnings_match_jax(files):
    """A missing phenotype: imputed by the mean for a Gaussian trait,
    the JAX package's error for another; an mv fit on one column; an
    integer column of a VCF; an unknown file; PLINK with dosage; a
    covariate file without an intercept warns."""
    fam = (files / "w.fam").read_text().splitlines()
    fam[4] = "\t".join(fam[4].split("\t")[:5] + ["-9"])
    fam[7] = "\t".join(fam[7].split("\t")[:5] + ["NA"])
    (files / "miss.fam").write_text("\n".join(fam) + "\n")
    for ext in (".bed", ".bim"):
        shutil.copy(files / f"w{ext}", files / f"miss{ext}")
    jx = m.read_plink(str(files / "miss"))
    tx = mt.read_plink(str(files / "miss"), device="cpu")
    np.testing.assert_array_equal(tw.parse_phenotypes(tx, 6, mt.Normal()),
                                  jw.parse_phenotypes(jx, 6, m.Normal()))
    cases = [
        (lambda w, x, d: w.parse_phenotypes(x, 6, d.Bernoulli()), True),
        (lambda w, x, d: w.parse_phenotypes(x, 6, d.MvNormal()), True),
        (lambda w, x, d: w.parse_phenotypes(np.zeros((3, 3)), 6, d.Normal()),
         False),
        (lambda w, x, d: w.parse_genotypes(str(files / "absent.txt")), False),
        (lambda w, x, d: w.parse_genotypes(str(files / "w"), dosage=True),
         False),
    ]
    for fn, plink in cases:
        with pytest.raises(ValueError) as ej:
            fn(jw, jx if plink else None, m)
        with pytest.raises(ValueError) as et:
            fn(tw, tx if plink else None, mt)
        assert str(et.value) == str(ej.value)
    Z = np.column_stack([np.full(30, 2.0), np.arange(30.0)])
    np.savetxt(files / "noint.csv", Z, delimiter=",")
    zt, wt = _stderr(tw.parse_covariates, str(files / "noint.csv"))
    zj, wj = _stderr(jw.parse_covariates, str(files / "noint.csv"))
    np.testing.assert_array_equal(zt, zj)
    assert wt == wj and "no intercept detected" in wt


def _write_bgen(path, G8, ns):
    """An uncompressed layout-2 BGEN (v1.2) of 8-bit (p11, p12) probability
    pairs G8 (variants, ns, 2), the layout of tests/test_genotype.py."""
    def vstr(s):
        return struct.pack("<H", len(s)) + s.encode()
    body = b""
    for v, probs in enumerate(G8):
        body += vstr(f"v{v}") + vstr(f"rs{v}") + vstr("1")
        body += struct.pack("<IH", 100 * (v + 1), 2)
        for a in "AG":
            body += struct.pack("<I", 1) + a.encode()
        raw = (struct.pack("<IH", ns, 2) + bytes([2, 2]) + bytes([2] * ns)
               + bytes([0, 8]) + probs.astype(np.uint8).tobytes())
        body += struct.pack("<I", len(raw)) + raw
    header = struct.pack("<IIII4sI", 20, 20, len(G8), ns, b"bgen", 2 << 2)
    with open(path, "wb") as f:
        f.write(header + body)


def test_parse_genotypes_bgen_matches_jax(files):
    """A BGEN file beside its ``.sample`` file: the JAX package's
    standardized matrix and sample ids, exactly."""
    G8 = np.random.default_rng(37).integers(0, 128, size=(6, 9, 2))
    _write_bgen(str(files / "g.bgen"), G8, 9)
    (files / "g.sample").write_text(
        "ID_1 ID_2\n0 0\n" + "".join(f"id{i} id{i}\n" for i in range(9)))
    got = tw.parse_genotypes(str(files / "g.bgen"), device="cpu")
    want = jw.parse_genotypes(str(files / "g.bgen"))
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.tolist() == b.tolist()
    assert got[1].tolist() == [f"id{i}" for i in range(9)]


def test_wrappers_need_a_device(files, monkeypatch):
    """No CUDA device and no device given: every entry point raises rather
    than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
            lambda: mt.iht(str(files / "w"), K, mt.Normal, verbose=False),
            lambda: mt.iht(str(files / "w.vcf"), K, mt.Normal,
                           phenotypes=str(files / "w.phen"), verbose=False),
            lambda: mt.cross_validate(str(files / "w"), mt.Normal,
                                      verbose=False),
            lambda: mt.parse_genotypes(str(files / "w")),
            lambda: mt.fit_iht(np.zeros(4), np.eye(4), k=1, verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_exports_match_jax():
    """The port exports exactly the names of the JAX package's ``__all__``
    (``HostStreamedGenotypes``, out of core, among them), each
    one it names."""
    assert set(mt.__all__) == set(m.__all__)
    assert len(mt.__all__) == len(set(mt.__all__))
    assert all(hasattr(mt, name) for name in mt.__all__)
