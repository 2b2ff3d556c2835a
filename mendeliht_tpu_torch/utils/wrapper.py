"""File-level API: `iht` and `cross_validate` on PLINK/VCF/BGEN inputs
(reference src/wrapper.jl; the JAX package's ``utils/wrapper.py``).

A PLINK trio stays 2-bit packed and is repacked on ``device``; a VCF or
BGEN file becomes a standardized float64 matrix on the host, which the fits
take to ``device`` as a dense f32 design (``ops.linalg.DenseOp``).  Every
entry point's ``device`` defaults to the card and raises where there is
none (pass ``device="cpu"``).

Output files mirror the reference formats (summary, tab-separated beta table
with chr/pos/snpid/ref/alt, trait-covariance for multivariate).  The
reference's wrapper.jl:117 bug — overwriting the freshly-written beta file
with an empty table — is intentionally NOT replicated, as in the JAX
package."""

from __future__ import annotations

import os
import sys
import time as _time

import numpy as np
import torch

from ..genotype.plink import SnpData, read_plink
from ..genotype.vcf import read_vcf
from ..models.cv import cv_iht
from ..models.fit import fit_iht, is_multivariate
from ..models.results import print_cv_results
from ..ops import glm
from .device import resolve_device
from .standardize import standardize


def isplink(tgtfile: str) -> bool:
    return all(os.path.isfile(tgtfile + ext) for ext in (".bed", ".fam", ".bim"))


def standardize_genotypes(G: np.ndarray) -> np.ndarray:
    """Center/scale/impute a dense dosage matrix per SNP with the
    genotype-specific sigma = sqrt(mu(1-mu/2)); NaN -> mean
    (reference src/wrapper.jl:406-423)."""
    G = np.array(G, np.float64, copy=True)
    mu = np.nanmean(G, axis=0)
    mu = np.where(np.isnan(mu), 0.0, mu)
    sd = np.sqrt(np.maximum(mu * (1.0 - mu / 2.0), 0.0))
    inds = np.isnan(G)
    G[inds] = np.broadcast_to(mu, G.shape)[inds]
    G -= mu
    nz = sd > 0
    G[:, nz] /= sd[nz]
    return G


def parse_genotypes(tgtfile: str, dosage: bool = False, device=None):
    """Dispatch on file extension (reference src/wrapper.jl:451-485).

    Returns (X, sampleID, chr, pos, ids, ref, alt) where X is a SnpData
    (PLINK: stays 2-bit packed, on ``device``, default the card) or a dense
    standardized float64 numpy matrix (VCF/BGEN)."""
    if tgtfile.endswith(".vcf") or tgtfile.endswith(".vcf.gz"):
        G, sid, chrs, poss, ids, refs, alts = read_vcf(tgtfile, dosage=dosage)
        X = standardize_genotypes(G)
        return X, sid, chrs, poss, ids, refs, alts
    if tgtfile.endswith(".bgen"):
        from ..genotype.bgen import read_bgen
        sample_path = tgtfile[:-5] + ".sample"
        G, sid, chrs, poss, ids, refs, alts = read_bgen(
            tgtfile, sample_path=sample_path if os.path.isfile(sample_path) else None)
        X = standardize_genotypes(G)
        return X, sid, chrs, poss, ids, refs, alts
    if isplink(tgtfile):
        if dosage:
            raise ValueError("PLINK files detected but dosage = true!")
        X = read_plink(tgtfile, device=device)
        si = X.snp_info
        return (X, X.person_info["iid"], si["chromosome"], si["position"],
                si["snpid"], si["allele1"], si["allele2"])
    raise ValueError(
        "Unrecognized target file format: target file can only be VCF files "
        "(ends in .vcf or .vcf.gz), BGEN (ends in .bgen) or PLINK (do not "
        "include .bim/bed/fam) and all trio must exist in 1 directory)")


def phenotype_is_missing(s: str) -> bool:
    return s == "-9" or s == "NA"


def _load_delimited(filename: str) -> np.ndarray:
    """Numeric table with delimiter auto-detection (the reference reads
    phenotype/covariate files via readdlm, which sniffs the separator:
    reference src/wrapper.jl:136-218, :228-247).  Comma-, tab-, or
    whitespace-separated files all parse to the same matrix."""
    with open(filename, "r") as f:
        first = ""
        for line in f:
            if line.strip():
                first = line
                break
    if "," in first:
        delimiter = ","
    elif "\t" in first:
        delimiter = "\t"
    else:
        delimiter = None        # np.loadtxt: any run of whitespace
    return np.loadtxt(filename, delimiter=delimiter, ndmin=2)


def parse_phenotypes(X, col, d):
    """Phenotypes from .fam columns or a CSV file
    (reference src/wrapper.jl:126-218). `col` may be an int (1-based .fam
    column, default 6), a list of ints (multivariate), or a filename."""
    dist = glm.dist_name(d)
    if isinstance(col, str):
        y = _load_delimited(col)
        if is_multivariate(y.T):
            return np.ascontiguousarray(y.T)       # (r, n)
        return y.reshape(-1)
    if not isinstance(X, SnpData):
        raise ValueError("Integer phenotype columns require PLINK input; "
                         "pass a phenotype file instead")
    cols = [col] if isinstance(col, (int, np.integer)) else list(col)
    if dist == "mvnormal" and len(cols) < 2:
        raise ValueError(
            "Multivariate analysis requires multiple phenotypes! Please "
            "specify e.g. phenotypes=[6, 7] or a comma-separated file.")
    n = X.people
    out = np.zeros((len(cols), n))
    for ci, c in enumerate(cols):
        raw = X.person_info[str(c)]
        missing = np.array([phenotype_is_missing(v) for v in raw])
        vals = np.array([0.0 if m else float(v) for v, m in zip(raw, missing)])
        if missing.any():
            if dist in ("normal", "mvnormal"):
                vals[missing] = vals[~missing].mean()
            else:
                i = int(np.flatnonzero(missing)[0])
                raise ValueError(
                    f"Missing phenotype detected for sample {i + 1}. Automatic "
                    "phenotype imputation is only possible for quantitative "
                    "traits. Please exclude or impute missing phenotypes first.")
        out[ci] = vals
    if dist == "mvnormal":
        return out                                  # (r, n)
    return out[0]


def parse_covariates(filename: str, exclude_std_idx=(), standardize_cols=True,
                     **kwargs):
    """Delimited covariates (comma/tab/whitespace auto-detected), first
    column = intercept; all columns not excluded are standardized
    (reference src/wrapper.jl:228-247)."""
    if "standardize" in kwargs:
        standardize_cols = kwargs.pop("standardize")
    z = _load_delimited(filename)
    q = z.shape[1]
    exclude_std_idx = np.asarray(exclude_std_idx)
    if exclude_std_idx.dtype == bool:
        std_idx = ~exclude_std_idx
    else:
        std_idx = np.ones(q, bool)
        if exclude_std_idx.size:
            std_idx[exclude_std_idx.astype(int) - 1] = False
    if np.all(z[:, 0] == 1):
        std_idx[0] = False
    else:
        print("Warning: covariate file provided but no intercept detected. "
              "An intercept will NOT be included in IHT!", file=sys.stderr)
    if standardize_cols and std_idx.any():
        z[:, std_idx] = standardize(z[:, std_idx])
    return z


def _write_beta(path, chrs, poss, ids, refs, alts, beta, traits=1):
    with open(path, "w") as f:
        if traits == 1:
            f.write("chr\tpos\tSNPid\tref\talt\tEstimated_beta\n")
            for row in zip(chrs, poss, ids, refs, alts, beta):
                f.write("\t".join(str(v) for v in row) + "\n")
        else:
            f.write("chr\tpos\tSNPid\tref\talt")
            for t in range(traits):
                f.write(f"\tbeta_{t + 1}")
            f.write("\n")
            for j, row in enumerate(zip(chrs, poss, ids, refs, alts)):
                f.write("\t".join(str(v) for v in row))
                for t in range(traits):
                    f.write(f"\t{beta[t, j]}")
                f.write("\n")


def _design(filename, phenotypes, d, covariates, exclude_std_idx, dosage,
            device):
    """(x, y, z, the beta file's variant columns) of a genotype file: x the
    packed genotypes on ``device`` or the dense f32 matrix there; z the
    covariates, (q, n) for a multivariate y."""
    device = resolve_device(device)
    X, _, chrs, poss, ids, refs, alts = parse_genotypes(filename, dosage,
                                                         device)
    if isinstance(X, SnpData):
        xmat, n = X.snparray, X.people
    else:
        xmat = torch.as_tensor(X, dtype=torch.float32, device=device)
        n = X.shape[0]
    y = parse_phenotypes(X, phenotypes, d)
    z = (np.ones(n) if covariates == "" else
         parse_covariates(covariates, exclude_std_idx, standardize_cols=True))
    if is_multivariate(y):
        z = np.ascontiguousarray(np.atleast_2d(z.T) if z.ndim > 1 else
                                 z.reshape(1, -1))
    return xmat, y, z, (chrs, poss, ids, refs, alts)


def _family(d):
    """(the family instance, its link: LogLink for the negative binomial,
    else the canonical one)."""
    d = d() if isinstance(d, type) else d
    l = glm.LogLink() if glm.dist_name(d) == "negativebinomial" else \
        glm.canonicallink(d)
    return d, l


def iht(filename: str, k: int, d, phenotypes=6, covariates: str = "",
        summaryfile: str = "iht.summary.txt", betafile: str = "iht.beta.txt",
        covariancefile: str = "iht.cov.txt", exclude_std_idx=(),
        dosage: bool = False, device=None, **kwargs):
    """Run IHT at sparsity k from genotype files (reference
    src/wrapper.jl:52-120) on ``device`` (default the card)."""
    xmat, y, z, variants = _design(filename, phenotypes, d, covariates,
                                   exclude_std_idx, dosage, device)
    d, l = _family(d)
    verbose = kwargs.pop("verbose", True)
    # tee the signature, parameter banner and per-iteration progress lines
    # into the summary file, then append the result block (reference
    # wrapper.jl:83-92: fit_iht(..., io=io) + show(io, result))
    with open(summaryfile, "w") as f:
        result = fit_iht(y, xmat, z, k=k, d=d, l=l, verbose=verbose, io=f,
                         **kwargs)
        f.write(str(result))
        f.write("\n")
    if is_multivariate(y):
        _write_beta(betafile, *variants, result.beta, traits=result.traits)
        np.savetxt(covariancefile, result.Sigma)
    else:
        _write_beta(betafile, *variants, result.beta)
    return result


def cross_validate(filename: str, d, path=None, phenotypes=6,
                   covariates: str = "", cv_summaryfile: str = "cviht.summary.txt",
                   q: int = 5, exclude_std_idx=(), dosage: bool = False,
                   device=None, **kwargs):
    """Cross-validate sparsity levels from genotype files (reference
    src/wrapper.jl:301-349) on ``device`` (default the card)."""
    start = _time.time()
    path = list(path) if path is not None else list(range(1, 21))
    xmat, y, z, _ = _design(filename, phenotypes, d, covariates,
                            exclude_std_idx, dosage, device)
    d, l = _family(d)
    kwargs.setdefault("show_progress", kwargs.get("verbose", True))
    mse = cv_iht(y, xmat, z, path=path, q=q, d=d, l=l, **kwargs)
    with open(cv_summaryfile, "w") as f:
        best_k = path[int(np.argmin(mse))]
        print_cv_results(f, mse, path, best_k)
        f.write(f"Total cross validation time = {_time.time() - start} seconds\n")
    return mse
