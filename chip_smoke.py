#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mendeliht_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises (non-zero exit, no
result line):

1. device     name, ``nvidia-smi`` name and power limit; TF32 off
2. build      the four CUDA sources of ``mendeliht_tpu_torch/csrc``, one
              nvcc each, all started together; ptxas register/spill lines,
              and the registers, spills and shared memory of kernels 1, 2
              (and 6) and 7 (``xt_dots_t.cu``, one body, three layouts) and
              of the float64 score's raw-sum entries of kernels 1 and 2
              summed up
3. kernel     kernel 1 (``xt_dots_words``, quad words, int8 digit planes on
              the tensor cores) vs its plain PyTorch version on the card,
              bit for bit: n=10k x p=65,536 and n=200k x p=4,096 (long
              per-SNP sums), both with missing genotypes, at m in {1, 8,
              100} for every output combination, a NaN column; at 10k x 1M
              kernel and plain at m in {1, 8, 100}, each checked and timed
              beside the int8 bound (3 digit planes a wanted output)
4. kernel-t   kernel 2 (``xt_dots_words_t``, transposed dual layout, the
              same function): the same cases against its plain version bit
              for bit, ``build_words_t`` on the card equal to the CPU and
              its time at 10k x 1M; at 10k x 1M for m in {1, 8, 100} its A
              and M equal to kernel 1's, then kernel and plain bit for bit
              and timed beside the int8 bound and the share of it; after the
              lab, kernel 6's m=100 time against kernel 2's in the same run
              (the same body and work: within 10%); at the end of the run
              (after every profile phase, so that no other profiler session
              runs before one) the kernel launches of one call
   moments    kernels 1 and 2 at the widths of ``PackedOp.col_moments``
              (the init_beta warm start's score pass, m = 2B: 2 for a fit,
              200 for the default cv) with the squared plane S on its R (0/1
              masks beside W y), at 10k x 1M: each bit for bit against its
              plain version and the two against each other, timed in turns
              beside their bound and one plain call
5. probe      kernel 3 (``read_words``) equal to its plain version on the
              10k x 1M words; the read ceiling through the profiling entry
              point, the plain rate, and ``kernel_roofline`` of both layouts
              at m in {1, 100}
6. parity     the same port fit (n=2,000, p=20,000, k=10) on the card and on
              the CPU: same support, iteration counts within one (the
              card's score takes R through 21-bit digits, the CPU operator
              runs the f32 function, as the JAX package's does off the TPU)
7. cv-parity  the same ``cv_iht`` (2,000 x 20,000, path 1:10, q=3, fixed
              folds) on the card and on the CPU: mse within 1e-4, same best
              k; then every family of FAMILIES fitted on the card and on the
              CPU at that size (responses from ``simulate_random_response``,
              seed 2026 + the family's index): same support, iterations
              within one; and the Bernoulli cv, path 1:10, q=3: mse within
              1e-4, same best k; then each fit option on the card and on the
              CPU at that size (init_beta, debias Gaussian and Bernoulli,
              groups, weights with zkeep): same support, iterations within
              one; and the init_beta cv, path 1:10, q=3: mse within 1e-4,
              same best k
   float64-parity  the float64 fit (k = 10) at 2,000 x 20,000 on the card
              (kernel 2's float64 entry) and on the CPU (the unquantised
              float64 score): same support and iterations, beta within 1e-9
              of max|beta|
   mv-parity  the multivariate fit (3 traits, k=12, the flagship response
              below; plain and with init_beta) on the card and on the CPU
              at that size, each line search traced: same (trait, SNP)
              support, logl within 4 f32 roundings before every iteration
              up to the first whose backtracks differ and at the end, Sigma
              within 1e-3 and B within 3e-3 of their max, iterations within
              one, or within 6 where the first difference is a
              loglikelihood tie (the full step's logl within 4 roundings of
              the last on both devices; both traces printed from three
              iterations before it); the CPU fit with the score left
              without Gamma (a known fault) outside those bounds; then the
              mv cv, path 2:2:20, q=3, fixed folds: mse within 1e-4, same
              best k
8. fit        ``fit_iht`` at 10k x 1M, k=10 (the JAX package's headline
              size) through ``PackedOp`` (quad words, kernel 1) and through
              the genotypes (dual layout, kernel 2), cold then FIT_WARM warm
              runs each: identical support, iterations and logl (the two
              kernels compute one function), causal recovery, the warm
              median and range
9. cv         ``cv_iht`` at 10k x 1M, path 1:20, q=5 (B=100 tasks, every
              score pass at m=100) on its default path, cold then CV_WARM
              warm runs on the same folds: finite mse, best k, iterations
              from the solver state, kernel-2 launches, peak memory; then
   cv-quad    the same cv through ``PackedOp`` of the genotypes without
              ``words_t`` (kernel 1, as every cv past the dual-layout
              budget runs), cold then CVQ_WARM warm runs: mse equal to the
              dual cv's bit for bit, best k 10, kernel-1 launches and no
              kernel-2 launch, the warm median and range
   sharded    the multi-GPU path (``mendeliht_tpu_torch.parallel``) on
              the one card: (a) a world of one rank on NCCL in this
              process, ``ShardedPackedOp`` over the whole genotypes: its
              ``xtr`` at m = 1 and 100 torch.equal to kernel 1 on the
              quad-word ``PackedOp``, one launch a call, kernel 1 on the
              shard's words equal to its plain version; the fit (k = 10)
              and the cv (the cv phase's grid and folds) through it equal
              to the quad-word ones bit for bit (support, iterations,
              logl, betas, c; mse), timed cold and warm in turns with them
              (the hooks' cost); (b) SHARD_RANKS rank processes on the one
              card over gloo, the genotypes written as a PLINK trio and
              each rank's half read by ``multihost.load_bed_shard``: the
              fit and cv against the single-device quad-word ones (the
              same support and best k, iterations within one, betas within
              SHARD_BETA_TOL, mse within SHARD_MSE_TOL relative), both
              ranks the same result, each rank's kernel-1 launches,
              collectives, walls and peak memory; after the kprobe phase
              (sharded-profile), a ``profiling.trace`` of a warm
              quad-word and a warm world-of-1 sharded fit and cv
10. profile   ``profiling.trace`` over one warm cv and one warm dual fit:
              wall, device busy and idle share, launches, syncs, the
              heaviest device kernels
    float64   (run after mv: see main) float64 fits at 10k x 1M: kernels 2
              and 1's float64 entries
              (``xt_dots_words_t_f64``, ``xt_dots_words_f64``) at m = 1, 8,
              100 and 200 with S, their digit sums bit for bit against the
              plain ones (``decode.digit_sums64``, a chunk of SNPs at a
              time), their float64 scores bit for bit against the plain
              float64 score and each other and within 1e-13 * n_pad *
              max|R_col| of the unquantised float64 ``decode.xt_dots``,
              timed in turns (the whole score call, and the raw-sum entry
              alone) beside their bound and one plain call; the Gaussian
              fit (k = 10) through both layouts, cold and warm (identical;
              the f32 fit's support, 10/10 causal); the cv (path 1:20, q =
              5, the cv phase's folds) through both layouts (mse equal bit
              for bit, the f32 cv's best k, peak memory); the init_beta fit
              (S); the Bernoulli fit beside the f32 one (support and
              iterations: the check ROADMAP Queue 3 owed); a
              ``profiling.trace`` of a warm float64 cv and fit
11. lab       the kernel lab (``mendeliht_tpu_torch.tools.kernel_lab5``) on
              the same 10k x 1M genotypes: ``main(["--quick"])`` (int4
              probes, int8/int4 ingestion, quad and int8 digit-plane score
              at m in {1, 8, 100}) and ``main(["--attrib"])`` with every
              launch count set to 0 before and read after, each of the six
              kernels launched; the probe verdicts against the reference's;
              the sweep of kernels 1, 2 and 6 over m = 1..128; kernels 4
              and 5 equal to their plain versions at the lab's shapes
              (kernel 5 also on random full-range operands, int4 and int8)
              and timed by profiler device time (CUDA events would time the
              host's launches): kernel 5 cold (the L2 emptied by a 128 MB
              read before each call) and warm (the lab's loop on one
              operand), ``torch._int_mm``'s timed both ways beside it and
              kernel 3's cold read of the same words as the yardstick;
              int4 faster than int8 cold, int8 ahead of ``torch._int_mm``;
              kernel 4's unpack and packed-rhs probe dot (``rhs_dot_kernel``,
              its unguarded and its guarded instantiation) each timed in
              turns with a zero fill of its output, the least a launch that
              writes those bytes takes (its one-launch floor); the unguarded
              one no slower than the guarded one
12. kprobe    the round-3 kernel probe
              (``mendeliht_tpu_torch.tools.kernel_probe``) on the same 10k x
              1M genotypes: kernel 7 (``xt_i8_rounds``) equal to its plain
              version for m in {1, 8, 64} at the probe's tp = 1024, 512 and
              2048, and to kernels 6 and 2's A on the transposed words,
              timed beside its bound; kernels
              8 and 9 (``stream_xor``,
              ``decode_only``) equal to plain on the quad words at tp = 1024
              (a ragged last tile) with a seed of 0 and one that wraps, timed
              in turns (8, 9, 9, 8), kernel 9 within 25% of kernel 8 (the
              same reads);
              then ``main(["1", "8", "64"])`` with every launch count set to
              0 before and read after, each of the three kernels launched
              and no variant failed
    families  the other GLM families on the same 10k x 1M genotypes (after
              the kernel-6 gate), responses from ``simulate_random_response``
              with seed 2026 + the family's index: the Bernoulli (logit)
              fit through both layouts, cold then FAM_FIT_WARM warm runs
              (identical, exactly k selected, causal recovered, launches);
              the Bernoulli cv on cv_iht's default path, cold then
              FAM_CV_WARM warm runs on the same folds (finite mse, best k,
              kernel-2 launches, peak memory); then the Poisson, negative
              binomial (est_r Newton and MM), Gamma and inverse Gaussian
              (log link) fits on the dual layout, each cold and warm, with
              exactly k selected, a finite logl, causal recovered, the
              estimated r, and a ``profiling.trace`` of one warm fit of
              every family (launches, syncs, device idle share)
    options   the fit options on the same 10k x 1M genotypes: the init_beta
              fit through both layouts, cold then OPT_FIT_WARM warm runs
              (identical, exactly k selected, causal recovered); the
              init_beta cv on the cv phase's folds, cold then OPT_CV_WARM
              warm runs (finite mse, best k, kernel-2 launches, peak
              memory); the debiased Gaussian and Bernoulli fits, the group
              fit (1,000 groups of 1,000 SNPs, at most J = 5 groups of k = 2)
              and the weighted fit (``maf_weights``) with a two-column z and
              zkeep [True, False], each cold and warm with its selection
              checked; a ``profiling.trace`` of a warm init_beta cv and a
              warm debiased fit
    mv        kernels 1 and 2 at the mv path's widths on the same 10k x 1M
              genotypes (m = 3, the fit's score; 45, a 15-task cv chunk's;
              30 with S, the chunk's init_beta col_moments), as the moments
              phase holds them; then the JAX package's flagship
              multivariate protocol on them (``bench.py::run_flagship``): a
              3-trait response from ``default_rng(31)`` (10 shared causal SNPs,
              effects N(0, 0.5^2), B X by ``forward_sel_multi`` on the card,
              noise of covariance ``random_covariance_matrix``); the fit
              (k=12, init_beta, min_iter=10) through both layouts, cold then
              MV_FIT_WARM warm runs each (identical support, iterations and
              logl; exactly 12 entries; causal SNP columns recovered); the
              UKBB-protocol cv (path 100:100:1000, q=3, init_beta,
              min_iter=10, folds from ``default_rng(5)``: 30 tasks in two
              chunks of 15, every score pass at m=45), cold then MV_CV_WARM
              warm runs (the same mse; best k, iterations, kernel-2
              launches, peak memory); a ``profiling.trace`` of a warm fit
              and of the first chunk of a warm cv
    io        the file-level API on the same 10k x 1M genotypes, in a
              temporary directory removed after: a PLINK trio written from
              the card words (``write_plink_bed``, a chunk of SNPs at a
              time) with the fit's y in ``.fam`` column 6, and a second
              ``.fam`` with the mv phase's three traits; ``read_plink`` on
              the card, its words and mu / inv_sd bit-equal to the
              genotypes', its wall split into the file read, the upload and
              the repack; ``HostStreamedGenotypes.from_plink`` of the trio,
              its host words and stats bit-equal to ``read_plink``'s; ``iht(prefix, 10, Normal)`` bit-equal to
              ``fit_iht`` in memory (beta, c, logl, iterations; kernel-2
              launches; a beta file of p rows); ``cross_validate`` (path
              1:20, q=5, the cv phase's folds) bit-equal to the cv phase's
              mse, best k 10; the 3-trait ``iht`` (k=12, phenotypes=[6, 7,
              8]) bit-equal to ``fit_iht`` on the same Y, its covariance
              file written; then at 2,003 x 20,000 with missing calls (n %
              4 = 3) the card's read equal to the CPU's
    dense     the dense design (``DenseOp``): a VCF (GT) of the parity
              genotypes, ``parse_genotypes`` within 1e-12 of the PLINK
              trio's standardized matrix, its ``iht`` on the card and on the
              CPU (same support, iterations within one) and the same
              support as the PLINK ``iht`` on the card, no score kernel
              launched by the dense fits; ``grm`` on the card at 2,000 x
              20,000 within 1e-4 relative of the CPU's float64 loop; then
              100,000 f32 standardized columns of the 10k x 1M genotypes
              (every causal SNP among them, made by ``gather_cols`` on the
              card): ``DenseOp.xtr`` with TF32 switched on bit-equal to it
              with TF32 off, ``fit_iht`` (k=10) and ``cv_iht`` (path 1:20,
              q=5), cold then DENSE_WARM warm runs (identical; causal
              recovery against the packed fit's; best k 10; peak memory),
              and a ``profiling.trace`` of a warm fit and a warm cv
    hostlink  the host-to-device rate of a 1 GiB block, pageable and
              page-locked in place (``cudaHostRegister``), in turns
    stream    out of core (``HostStreamedGenotypes``) on the same 10k x 1M
              genotypes, their words in host memory, nothing resident,
              blocks of 256 MiB (10 a pass): the streamed ``xtr`` at m = 1
              and 100 and ``col_moments`` (with S) torch.equal to kernel 1
              on the resident words and to its plain version
              (``decode.xt_dots_words``), the pass timed against the link
              bound (the streamed bytes over the measured registered rate
              and over the data sheet's); a ``profiling.trace`` of a pass
              (copies, kernel 1, idle share); the k = 10 fit, the cv (path
              1:20, q = 5, the cv phase's folds) and the 3-trait mv fit
              (k = 12, init_beta) equal to the quad-word runs bit for bit,
              with kernel-1 launches, block copies and index fetches, and
              the fit again through ``fit_iht(y, genotypes)``, whose new
              operator reuses the registration; a cv
              checkpointed every 5 iterations, killed by max_iter = 8 and
              resumed, equal to the plain cv bit for bit, each ~1.6 GB save
              timed
    hybrid    the JAX package's out-of-core size: 80,000 x 1M (8 copies of
              the 10k samples, 20.48 GB packed; mu and 1/sd unchanged; y
              from ``phenotype``) at the default budget (10 GiB resident,
              1 GiB blocks): the passes at m = 1 and 100 and
              ``col_moments`` equal to kernel 1 resident and to its plain
              version and timed, a traced pass split into the prefix's
              kernel, the copies and the blocks' kernels, and the k = 10
              fit equal to the resident quad-word fit bit for bit, also
              through ``fit_iht(y, genotypes)`` (the registration and the
              prefix reused)
13. cv-miss   the same cv on 10k x 1M genotypes with missing calls (the
              score with its missing plane), after kernels 2 and 1 vs plain
              bit for bit and equal to each other, timed at m=100 on them
              beside their bound (6 planes), and at the moments phase's
              widths with S and M; then ``profiling.trace`` of one warm cv
              on them; then (float64-miss) the float64 entries with M at m
              = 100 as the float64 phase holds them, and the float64 cv on
              those genotypes with the f32 cv's best k
14. budget    past the 3 GiB dual-layout budget, after every other genotype
              is freed: 51,200 x 1,000,000 random quad words made on the card
              (12.8 GB, every crumb code), ``build_words_t`` of them (timed),
              kernels 1 and 2 at m in {1, 100} with the missing plane equal
              bit for bit and timed in turns beside their bound
15. result    a JSON line of the kernels, then ``{"ok": true, "device": ...}``

Between phases 4 and 5, ``kernel-i8`` holds kernel 6 (``xt_dots_T``, kernel
2's A with a zero guard) to its plain version and to kernel 2's A, bit for
bit, on the kernel cases' genotypes and at 10k x 1M for m in {1, 8, 100},
and times it there beside its bound; then kernel 7 to its plain version,
bit for bit, on the round-3 words of the kernel cases at m in {1, 8, 64}
(printed as ``[kprobe]``).

Kernel launch counts in the kernels line come from the runs of the paths
each kernel serves, with the counts set to 0 just before: the quad-word fit
(kernel 1; ``cv_launches`` from the cv-quad run, ``sharded_launches``
from the sharded phase's fit and cv in the world of one rank and on each
of the two ranks, ``family_launches`` from
the Bernoulli quad-word fit, ``options_launches`` from the init_beta
quad-word fit), the cv (kernel 2; ``family_launches`` from each family's
fit and the Bernoulli cv, ``options_launches`` from each option's fit and
the init_beta cv), ``mv_launches`` of kernels 1 and 2 from the mv phase's
quad-word fit, and its dual fit and cv (their ``*_mv`` fields are the mv
widths' times), ``io_launches`` of kernel 2 from the io phase's ``iht``,
``stream_launches`` of kernel 1 from the stream phase's pass, fit, cv and
mv fit and the hybrid phase's fit (with the ``stream_*`` and ``hybrid_*``
pass times beside their link bounds),
``cross_validate`` and multivariate ``iht``, the
read-ceiling measurement (kernel 3) and the lab run (kernels 4-6;
``lab_launches`` of every kernel) and the probe's
run (kernels 7-9; ``probe_launches`` of every kernel); the float64 entries
of kernels 1 and 2 (``xt_dots_words_f64``, ``xt_dots_words_t_f64``) from the
float64 quad-word fit and the float64 dual cv (their ``ms`` the whole
float64 score call at m = 1 and m = 100, ``raw_ms_*`` the raw-sum entry
alone).  Each entry's
``bound_ms`` is the larger of its bytes over the data sheet's memory rate
and its operations over the data sheet's rate for their type (f32 or int32
on the CUDA cores, int8 on the tensor cores), for this run's shapes.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mendeliht_tpu_torch import (Bernoulli, Gamma, HostStreamedGenotypes,
                                 InverseGaussian, LogLink, LogitLink,
                                 MvNormal, NegativeBinomial, Normal,
                                 PackedGenotypes, Poisson,
                                 cross_validate, cv_iht, fit_iht, grm, iht,
                                 maf_weights, make_bim_fam_files,
                                 parse_genotypes, random_covariance_matrix,
                                 read_plink, write_plink_bed)
from mendeliht_tpu_torch.genotype import plink, snparray
from mendeliht_tpu_torch.models import fit as fit_module, mv, univariate
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.ops.linalg import DenseOp, PackedOp
from mendeliht_tpu_torch.ops.streaming import StreamedPackedOp
from mendeliht_tpu_torch.tools import kernel_lab5 as lab
from mendeliht_tpu_torch.tools import kernel_probe as probe
from mendeliht_tpu_torch.utils import checkpoint, profiling
from mendeliht_tpu_torch.utils.simulate import (simulate_packed_problem,
                                                simulate_random_response)

N, P, K = 10_000, 1_000_000, 10          # the JAX package's headline fit
P_KERNEL = 65_536                        # SNPs of the kernel-vs-plain cases
N_DEEP, P_DEEP = 200_000, 4_096          # long per-SNP sums
N_PARITY, P_PARITY = 2_000, 20_000       # the card-vs-CPU fit and cv
CV_PATH, CV_Q = list(range(1, 21)), 5    # the reference-shaped cv grid
# warm runs after the cold one, and of the plain versions' timings below:
# few, so that the whole run keeps within its time budget (each warm run
# is checked equal to the cold one; the medians print beside their range)
FIT_WARM, CV_WARM, CVQ_WARM = 3, 2, 1
FAM_FIT_WARM, FAM_CV_WARM = 3, 2         # the families phase's
OPT_FIT_WARM, OPT_CV_WARM = 3, 2         # the options phase's
PLAIN_REPS = 1                           # plain calls a timing, twice
MOMENT_WIDTHS = (2, 200)                 # col_moments' m = 2B: fit, cv
# the mv phase's score widths, (m, with S): m = T·r, 3 for the fit and 45
# for a 15-task cv chunk, and the chunk's init_beta col_moments, m = 2T
MV_WIDTHS = ((3, False), (45, False), (30, True))
# the options phase's group fit: 1,000 groups of 1,000 consecutive SNPs,
# at most J groups of at most GROUP_K SNPs each
N_GROUPS, GROUP_J, GROUP_K = 1_000, 5, 2
# the families phase, in its order: (label, family, link, est_r); the
# response of each family comes from simulate_random_response with seed
# SEED + its index in FAMILY_SEEDS (the two negative-binomial fits share one)
FAMILIES = (("bernoulli", Bernoulli(), LogitLink(), "none"),
            ("poisson", Poisson(), LogLink(), "none"),
            ("negbin-newton", NegativeBinomial(), LogLink(), "newton"),
            ("negbin-mm", NegativeBinomial(), LogLink(), "mm"),
            ("gamma", Gamma(), LogLink(), "none"),
            ("invgauss", InverseGaussian(), LogLink(), "none"))
FAMILY_SEEDS = ("bernoulli", "poisson", "negativebinomial", "gamma",
                "inversegaussian")
# the multivariate phases: the JAX package's flagship mv protocol
# (bench.py::run_flagship (b)-(c)), the reference's UKBB hypertension cv:
# a 3-trait response over 10 shared causal SNPs, the fit at k = 12 and the
# cv on path 100:100:1000 with q = 3, both with init_beta and min_iter 10
MV_TRAITS, MV_K, MV_MIN_ITER = 3, 12, 10
MV_PATH, MV_Q = list(range(100, 1001, 100)), 3
MV_PARITY_PATH = list(range(2, 21, 2))
MV_FIT_WARM, MV_CV_WARM = 2, 1
# card vs CPU: Sigma within MV_SIGMA_TOL of its max and B within MV_B_TOL
# of its max, the loglikelihood within MV_LOGL_ULPS f32 roundings, before
# every iteration up to the first whose line searches differ and at the
# end.  An mv fit crawls to its end on a loglikelihood plateau (a scaled
# change ~0.8 of the last); there a tie between two f32 sums decides a
# backtrack, whose halved step can end one fit several iterations before
# the other: iterations within one, or within MV_ITER_SPREAD where the
# first difference is such a tie.  The phase prints the readings of a
# known fault beside them (the score without Gamma), which must fail
MV_SIGMA_TOL, MV_B_TOL, MV_LOGL_ULPS, MV_ITER_SPREAD = 1e-3, 3e-3, 4, 6
# the io phase's second read: n % 4 == 3, missing calls, at P_PARITY SNPs
IO_N = 2_003
# the dense phase: the standardized columns of the flagship genotypes that
# its fit and cv run on (4 GB of f32 at N samples), and their warm runs
DENSE_P, DENSE_WARM = 100_000, 2
N_BIG = 51_200                           # past the budget: 12.8 GB of words
# out of core: the host link timed on HOSTLINK_BYTES; 10k x 1M streamed in
# blocks of STREAM_BLOCK (~10 a pass), its checkpointed cv killed by
# max_iter = STREAM_KILL_AT (checkpoints at 5 and 7) and resumed; the JAX
# package's out-of-core size (STREAM.json: 80k x 1M) as HYBRID_COPIES
# copies of the 10k samples at the default 10 GiB resident budget
HOSTLINK_BYTES = 1 << 30
STREAM_BLOCK = 256 << 20
STREAM_CKPT_EVERY, STREAM_KILL_AT = 5, 8
HYBRID_COPIES = 8
# data sheet: PCIe Gen5 x16, 64 GB/s a direction
PCIE_BYTES_PER_S = 64e9
# the sharded phase: warm runs of the world-of-1 fit and cv, each in turns
# with the quad-word one, and of each rank's fit and cv; the ranks, and the
# timeout of their collectives and processes (s); the two-rank run against
# the single-device quad-word one: betas within SHARD_BETA_TOL absolute and
# the cv mse within SHARD_MSE_TOL relative (the forward products sum over
# the ranks in another f32 order; tests/test_multihost.py's bounds)
SHARD_FIT_WARM, SHARD_CV_WARM, SHARD_RANK_WARM = 3, 2, 1
SHARD_RANKS, SHARD_TIMEOUT = 2, 600
SHARD_BETA_TOL, SHARD_MSE_TOL = 1e-3, 1e-4
CV_MAX_ITER = 100                        # cv_iht's default
FIT_MAX_ITER = 200                       # fit_iht's default
SEED = 2026
CV_TOL = 1e-4      # cv mse, card vs CPU: f32 sums in another order
# the float64 phases: kernels 1 and 2's float64 entries at these widths
# (and 200 with S, 100 with M), the dual fit's warm runs, and the float64
# fit's beta, card vs CPU, within this share of max|beta|
F64_WIDTHS, F64_WARM, F64_PARITY_TOL = (1, 8, 100), 2, 1e-9
# the sources built, one nvcc each
SOURCES = ("xt_dots_t", "read_probe", "int_probe", "kernel_probe")
# kernel 6 runs kernel 2's body on the same words at the same width: its
# m = 100 time may exceed kernel 2's by no more than run-to-run noise
SAME_BODY_SLACK = 1.10
# peak rates of an H100 SXM (dense), operations per second: f32 on the CUDA
# cores and int8 on the tensor cores from the data sheet; int32 from the
# Hopper white paper, 64 INT32 lanes an SM x 132 SMs x 1.98 GHz boost
PEAK_OPS = {"f32": 67e12, "int8": 1979e12, "int32": 132 * 64 * 1.98e9}
LAB_KERNELS = ("xt_dots_words", "xt_dots_words_t", "read_words", "xt_dots_T",
               "unpack_words", "int_dot_packed")
PROBE_KERNELS = ("xt_i8_rounds", "stream_xor", "decode_only")
PROBE_WIDTHS = (1, 8, 64)            # the probe's default widths
PROBE_TPS = (512, 2048)              # its v1tp512 and v1tp2048 row tiles
WRAP_SEED = 2**31 - 3                # words + seed wraps in int32
# integer operations a word that the functions of kernels 8 and 9 need: the
# seed add and the xor; for the decode also h = (t >> 1) & 0x55555555 and its
# 16 crumb values' sum popc(h) + popc(h & t), 6 more (kernel 9's own form)
XOR_OPS = {"stream_xor": 2, "decode_only": 2 + 6}
# profiler traces of a timed run taken before device_ms gives up: on an
# H100 a trace has lost one kernel record of 200, or two, or 125, and only
# a trace that holds every call's kernels is read
TRACE_TRIES = 8
# bytes read between two cold calls of kernel 5: over twice the 50 MB L2
FLUSH_BYTES = 128 << 20
# kernel 9 reads what kernel 8 reads, with two popcounts a word more: timed
# in turns it may exceed kernel 8's time by no more than this
DECODE_SLACK = 1.25
# the reference lab's verdicts (tools/kernel_lab5.py::probe_int4): its
# int4 x int4 operands do not match, so that one is dot_general's error
PROBE_VERDICTS = {
    "bitcast_i32_to_i4": "ok", "dot_i4_i8": "ok",
    "dot_i4_i4_256x256_256x128": (
        "FAIL: TypeError: dot_general requires contracting dimensions to "
        "have the same shape, got (256,) and (128,)."),
    "dot_i8_lhs_i4_rhs": "ok"}
KERNELS = {
    "xt_dots_words": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:157"),
    "xt_dots_words_t": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:398"),
    "read_words": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/read_probe.cu",
        replaces="mendeliht_tpu/utils/profiling.py:68"),
    "unpack_words": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/int_probe.cu",
        replaces="tools/kernel_lab5.py:89"),
    "int_dot_packed": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/int_probe.cu",
        replaces="tools/kernel_lab5.py:134"),
    "xt_dots_T": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="tools/kernel_lab5.py:176"),
    "xt_i8_rounds": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="tools/kernel_probe.py:82"),
    "stream_xor": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/kernel_probe.cu",
        replaces="tools/kernel_probe.py:139"),
    "decode_only": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/kernel_probe.cu",
        replaces="tools/kernel_probe.py:165"),
    # the float64 score: kernels 1 and 2's raw-sum entries of the same body
    # (the JAX package's float64 score is its XLA decode.xt_dots, so no
    # pallas_call of its own: these entries stand in kernels 1 and 2's rows)
    "xt_dots_words_f64": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:157"),
    "xt_dots_words_t_f64": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:398"),
}


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


def same(a, b):
    """Bit for bit, NaN where NaN (torch.equal alone calls NaN unequal)."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps, match=None, skip=()):
    """Device ms per call of ``fn`` from a profiler trace of ``reps`` calls
    after one: the kernels whose name holds ``match`` (any name if None)
    and is not in ``skip``, or (neither given) all device activity.  For
    calls so short that CUDA events would time the host's launches
    instead."""
    fn()
    for _ in range(TRACE_TRIES):
        with profiling.trace(top=64) as s:
            for _ in range(reps):
                fn()
        if match is None and not skip:
            return s["device_busy_ms"] / reps
        hits = [(ms, n) for name, ms, n in s["kernels"]
                if (match is None or match in name) and name not in skip]
        count = sum(n for _, n in hits)
        # the trace must hold every call's kernels: a trace that lost
        # records would time a fraction of the calls
        if count and count % reps == 0:
            return sum(ms for ms, _ in hits) / reps
        print(f"[trace] {count} {match or 'timed'} kernels traced over "
              f"{reps} calls: traced again", flush=True)
    raise AssertionError(f"no whole trace of {reps} calls of {match}: "
                         f"{s['kernels']}")


def interleaved(kern, plain, reps, plain_reps):
    """(kernel ms, plain ms, runs): in turns plain, kernel, kernel, plain."""
    pl = [cuda_ms(plain, plain_reps)]
    kn = [cuda_ms(kern, reps), cuda_ms(kern, reps)]
    pl.append(cuda_ms(plain, plain_reps))
    return sum(kn) / 2, sum(pl) / 2, kn + pl


def genotypes(rng, n, p, missing, device):
    words, mu, inv_sd, has_missing, causal, beta = simulate_packed_problem(
        rng, n, p, k=K, missing=missing)
    g = PackedGenotypes.from_numpy(words, mu, inv_sd, n=n, p=p,
                                   has_missing=has_missing, device=device)
    return g, causal, beta


def phenotype(g, causal, beta, seed):
    """y = X beta + 1 + N(0, 1) over the causal SNPs, through the port."""
    idx = torch.as_tensor(causal[None, :], device=g.device)
    coef = torch.as_tensor(beta[None, :], dtype=torch.float32, device=g.device)
    xb = PackedOp(g).forward_sel(idx, coef, torch.ones_like(coef))
    xb = xb[0, :g.n].cpu().double().numpy()
    return xb + 1.0 + np.random.default_rng(seed).standard_normal(g.n)


def rhs_on(g, m, gen):
    rhs = torch.randn((g.n_pad, m), generator=gen, device=g.device)
    rhs[g.n:] = 0.0
    return rhs


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(card, flush=True)
    return card.splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(kernels.build_library, SOURCES))
    print(f"[build] {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for ln in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"[build] {lib.stem}: {ln.strip()}", flush=True)
    log = next(lib for lib in libs if lib.stem.startswith("xt_dots_t-"))
    text = log.with_suffix(".log").read_text()
    smem = sorted(set(re.findall(r"(\d+) bytes smem", text)))
    # each instantiation's block of the log; its last two template
    # arguments are the layout (Layout: 0 T, 1 QUAD, 2 ROW) and RAW
    found = {}
    for block in text.split("Compiling entry function '")[1:]:
        key = re.search(r"LayoutE(\d)ELb(\d)E",
                        block.split("'", 1)[0]).groups()
        found.setdefault(key, []).append((
            int(re.search(r"Used (\d+) registers", block).group(1)),
            max(map(int, re.findall(r"(\d+) bytes spill", block)),
                default=0)))
    for kernel, key in (("1 (quad words)", ("1", "0")),
                        ("2 and 6 (transposed)", ("0", "0")),
                        ("7 (row-major)", ("2", "0")),
                        ("1's float64 raw-sum entry", ("1", "1")),
                        ("2's float64 raw-sum entry", ("0", "1"))):
        regs = [r for r, _ in found[key]]
        print(f"[build] kernel {kernel}, xt_dots_t.cu: {len(regs)} "
              f"instantiations, registers {min(regs)}-{max(regs)} a thread, "
              f"spill bytes {max(b for _, b in found[key])} at most, "
              f"static shared memory {smem} bytes (the stage ring is "
              "dynamic: 3-8 stages, sized at launch)", flush=True)


def check_cases(name, kernel, plain, arr, g, gen):
    """Kernel vs plain on the same card tensors at m in {1, 8, 100} for
    every output combination, then a NaN column, bit for bit; returns the
    worst relative error (0)."""
    worst = 0.0
    for m in (1, 8, 100):
        rhs = rhs_on(g, m, gen)
        for want_missing in (False, True):
            for want_sq in (False, True):
                kw = dict(want_missing=want_missing, want_sq=want_sq, p=g.p)
                got, ref = kernel(arr, rhs, **kw), plain(arr, rhs, **kw)
                sync()
                pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
                err = max(rel_err(a, b) for a, b in pairs)
                equal = all(same(a, b) for a, b in pairs)
                print(f"[{name}] n={g.n} p={g.p} m={m} missing={want_missing} "
                      f"sq={want_sq}: rel err {err:.3g}, bit-equal {equal}",
                      flush=True)
                if not equal:
                    raise AssertionError(f"{name} disagrees: {err}")
                worst = max(worst, err)
    rhs = rhs_on(g, 8, gen)
    rhs[123, 3] = float("nan")
    kw = dict(want_missing=True, want_sq=True, p=g.p)
    got, ref = kernel(arr, rhs, **kw), plain(arr, rhs, **kw)
    for out in (*got, *ref):
        if not (torch.isnan(out[:, 3]).all()
                and torch.isfinite(out[:, [0, 1, 2, 4, 5, 6, 7]]).all()):
            raise AssertionError(f"{name}: NaN not confined to column 3")
    if not all(same(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{name}: the NaN case differs from plain")
    print(f"[{name}] NaN in column 3: kernel and plain NaN there, finite "
          "elsewhere, bit-equal", flush=True)
    return worst


def time_widths(name, kernel, plain, arr, g, gen, widths=(1, 8, 100),
                bound_of=None):
    """Kernel vs plain on ``g`` at each width, with the outputs the score
    pass of a fit or cv asks for: first checked against each other bit for
    bit, then timed, beside ``bound_of(m)`` where given; returns {m:
    (kernel ms, plain ms, rel err, abs err)}."""
    times = {}
    for m in widths:
        rhs = rhs_on(g, m, gen)
        kw = dict(want_missing=g.has_missing, want_sq=False, p=g.p)
        got, ref = kernel(arr, rhs, **kw), plain(arr, rhs, **kw)
        sync()
        pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
        err = max(rel_err(a, b) for a, b in pairs)
        abs_err = max(float((a - b).abs().max()) for a, b in pairs)
        equal = all(same(a, b) for a, b in pairs)
        del got, ref, pairs
        if not equal:
            raise AssertionError(f"{name} disagrees at {g.n} x {g.p}, m={m}: "
                                 f"{err}, bit-equal {equal}")
        ms, plain_ms, runs = interleaved(
            lambda: kernel(arr, rhs, **kw), lambda: plain(arr, rhs, **kw),
            reps=20 if m == 1 else 5, plain_reps=PLAIN_REPS)
        times[m] = (ms, plain_ms, err, abs_err)
        share = ""
        if bound_of is not None:
            b = bound_of(m)
            share = (f", bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                     f"{b['bound_ms'] / ms:.3f} of it")
        print(f"[{name}] {g.n} x {g.p} m={m} missing={g.has_missing}: rel err "
              f"{err:.3g}, max abs err {abs_err:.3g}, bit-equal {equal}; "
              f"kernel {ms:.3f} ms (runs {runs[0]:.3f}, {runs[1]:.3f}), plain "
              f"{plain_ms:.3f} ms (runs {runs[2]:.3f}, {runs[3]:.3f}) per X'R "
              f"pass{share}", flush=True)
    return times


def errors(worst, times):
    """The kernels line's error fields: the worst over the small cases
    (relative) and the full-size widths."""
    return dict(max_abs_err=max(t[3] for t in times.values()),
                max_rel_err=max(worst, *(t[2] for t in times.values())))


def width_stats(times, widths, bound_of):
    """The kernels line's per-width fields: ms, plain ms and bound at each
    of ``widths`` (``times`` as ``time_widths`` returns them)."""
    out = {}
    for m in widths:
        out.update({f"ms_m{m}": times[m][0], f"plain_ms_m{m}": times[m][1],
                    f"bound_ms_m{m}": bound_of(m)["bound_ms"]})
    return out


def phase_kernel(small, g, gen):
    """Kernel 1 bit for bit against its plain version on the kernel cases
    and at 10k x 1M (m = 1, 8, 100), timed beside its int8 bound; the
    kernels line's entry leads with m = 1, the quad-word fit's width."""
    worst = max(check_cases("kernel", kernels.xt_dots_words,
                            decode.xt_dots_words, s.words, s, gen)
                for s in small)
    bound_of = int8_bound_of(g, missing=False)
    times = time_widths("kernel", kernels.xt_dots_words,
                        decode.xt_dots_words, g.words, g, gen,
                        bound_of=bound_of)
    return dict(**errors(worst, times), ms=times[1][0], plain_ms=times[1][1],
                m=1, **width_stats(times, (8, 100), bound_of))


def int8_bound_of(g, missing):
    """The ``bound_of`` of a score kernel (1 or 2) on ``g``: its int8 bound
    at width m, 3 digit planes a wanted output (A, and M if ``missing``)."""
    return lambda m: score_bound(g, m, "int8", 3 * (1 + missing))


def wrapper_launches(g, gen):
    """Kernel launches of one kernel-2 call (the wrapper's torch ops and
    the kernel) at m in {1, 100}, with and without the missing plane, from
    a profiler trace each; run last, after the profile phases."""
    for m in (1, 100):
        rhs = rhs_on(g, m, gen)
        for missing in (False, True):
            def call():
                kernels.xt_dots_words_t(g.words_t, rhs, want_missing=missing,
                                        p=g.p)
            call()
            sync()
            with profiling.trace() as s:
                call()
            print(f"[launches] kernel 2 m={m} missing={missing}: "
                  f"{s['launches']} kernel launches a call (the wrapper's "
                  "torch ops and the kernel)", flush=True)


def check_layouts(name, g, m, gen):
    """Kernels 1 and 2 on the same genotypes (``words`` and ``words_t``) at
    width m with the missing plane: every output equal bit for bit."""
    rhs = rhs_on(g, m, gen)
    kw = dict(want_missing=True, want_sq=False, p=g.p)
    quad = kernels.xt_dots_words(g.words, rhs, **kw)
    dual = kernels.xt_dots_words_t(g.words_t, rhs, **kw)
    sync()
    equal = all(same(a, b) for a, b in zip(quad, dual) if a is not None)
    print(f"[{name}] {g.n} x {g.p} m={m} missing={g.has_missing}: kernel 1 "
          f"A and M equal to kernel 2's {equal}", flush=True)
    if not equal:
        raise AssertionError(f"kernels 1 and 2 differ at m={m}")


def moments_rhs(g, m, gen):
    """The R of ``PackedOp.col_moments`` at width m = 2B, as it passes it
    to the score: B 0/1 fold masks W beside W * y (y standard normal),
    zero past the samples, as the (n_pad, m) transposed view of an (m,
    n_pad) tensor."""
    B = m // 2
    W = (torch.rand((B, g.n_pad), generator=gen, device=g.device) < 0.8)
    W = W.to(torch.float32)
    W[:, g.n:] = 0.0
    y = torch.randn((g.n_pad,), generator=gen, device=g.device)
    return torch.cat([W, W * y[None, :]]).T


def timed_call(fn):
    """(fn's result, its device ms) of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return out, start.elapsed_time(end)


def paired_widths(name, g, gen, widths, tag=""):
    """Kernels 1 and 2 at each (m, with S) of ``widths``, with the missing
    plane M where ``g`` misses calls: with S on the R that col_moments makes
    (``moments_rhs``), else on a random R; each bit for bit against its
    plain version and the two against each other, then timed in turns
    (kernel 2, kernel 1, kernel 1, kernel 2) beside their bound (the words,
    R and every output moved once; 3 digit planes of int8 operations a
    wanted output, S by its hi-bit plane) and one plain call; returns each
    kernel's fields for the kernels line, keyed ``ms_m{m}`` with ``_sq``
    for S, ``tag``, and ``_missing`` for M."""
    out = {"xt_dots_words": {}, "xt_dots_words_t": {}}
    for m, sq in widths:
        kw = dict(want_missing=g.has_missing, want_sq=sq, p=g.p)
        key = (f"m{m}{'_sq' if sq else ''}{tag}"
               f"{'_missing' if g.has_missing else ''}")
        what = "with S (col_moments' R)" if sq else "(a random R)"
        rhs = moments_rhs(g, m, gen) if sq else rhs_on(g, m, gen)
        calls, got = {}, {}
        for kname, kern, plain, arr in (
                ("xt_dots_words_t", kernels.xt_dots_words_t,
                 decode.xt_dots_words_t, g.words_t),
                ("xt_dots_words", kernels.xt_dots_words, decode.xt_dots_words,
                 g.words)):
            calls[kname] = (lambda k=kern, a=arr: k(a, rhs, **kw))
            got[kname] = calls[kname]()
            ref, plain_ms = timed_call(lambda: plain(arr, rhs, **kw))
            pairs = [(a, b) for a, b in zip(got[kname], ref) if b is not None]
            equal = all(same(a, b) for a, b in pairs)
            abs_err = max(float((a - b).abs().max()) for a, b in pairs)
            del ref, pairs
            if not equal:
                raise AssertionError(f"{name}: {kname} {what} at m={m} "
                                     "differs from plain")
            out[kname].update({f"plain_ms_{key}": plain_ms,
                               f"max_abs_err_{key}": abs_err})
        both = all(same(a, b) for a, b in zip(got["xt_dots_words"],
                                              got["xt_dots_words_t"])
                   if a is not None)
        del got
        if not both:
            raise AssertionError(f"{name}: kernels 1 and 2 differ {what} at "
                                 f"m={m}")
        reps = 10 if m <= 8 else 5 if m <= 64 else 3
        r2 = [cuda_ms(calls["xt_dots_words_t"], reps)]
        r1 = [cuda_ms(calls["xt_dots_words"], reps),
              cuda_ms(calls["xt_dots_words"], reps)]
        r2.append(cuda_ms(calls["xt_dots_words_t"], reps))
        outs = 1 + sq + g.has_missing            # A, S and M: each written
        b = bound(g.device, g.words.numel() * 4 + 4 * g.n_pad * m
                  + 4 * g.p * m * outs, 3 * outs * 2 * g.n_pad * g.p * m,
                  "int8")
        for kname, runs in (("xt_dots_words_t", r2), ("xt_dots_words", r1)):
            ms = sum(runs) / 2
            out[kname].update({f"ms_{key}": ms,
                               f"bound_ms_{key}": b["bound_ms"]})
            print(f"[{name}] {kname} {g.n} x {g.p} m={m} {what}, "
                  f"missing={g.has_missing}: bit-equal to plain and to the "
                  f"other kernel; {ms:.3f} ms (runs {runs[0]:.3f}, "
                  f"{runs[1]:.3f}), plain "
                  f"{out[kname][f'plain_ms_{key}']:.3f} ms (one call), "
                  f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}), "
                  f"{b['bound_ms'] / ms:.3f} of it", flush=True)
    return out


def moment_widths(name, g, gen):
    """Kernels 1 and 2 at the widths of ``PackedOp.col_moments`` (the
    init_beta warm start: m = 2 for a fit, 200 for the default cv) with the
    squared plane S (``paired_widths``)."""
    return paired_widths(name, g, gen, [(m, True) for m in MOMENT_WIDTHS])


def phase_kernel_t(small, g, gen):
    """Kernel 2 bit for bit against its plain version on the kernel cases
    and at 10k x 1M (m = 1, 8, 100), timed beside its int8 bound; its A and
    M equal to kernel 1's."""
    g65 = small[0]
    wt_cpu = kernels.build_words_t(g65.words.cpu(), g65.p)
    g65.with_dual_layout()
    if not torch.equal(g65.words_t.cpu(), wt_cpu):
        raise AssertionError("build_words_t on the card differs from the CPU")
    print(f"[kernel-t] build_words_t {g65.n} x {g65.p}: card equal to CPU",
          flush=True)
    worst = 0.0
    for s in small:
        s.with_dual_layout()
        worst = max(worst, check_cases("kernel-t", kernels.xt_dots_words_t,
                                       decode.xt_dots_words_t, s.words_t, s,
                                       gen))
        s.words_t = None

    sync()
    t0 = time.perf_counter()
    g.with_dual_layout()
    sync()
    print(f"[kernel-t] build_words_t {g.n} x {g.p}: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms "
          f"({g.words_t.numel() * 4 / 1e9:.2f} GB)", flush=True)
    for m in (1, 8, 100):
        check_layouts("kernel-t", g, m, gen)
    bound_of = int8_bound_of(g, missing=False)
    times = time_widths(
        "kernel-t", kernels.xt_dots_words_t, decode.xt_dots_words_t,
        g.words_t, g, gen, bound_of=bound_of)
    return dict(**errors(worst, times), ms=times[100][0],
                plain_ms=times[100][1], m=100,
                **width_stats(times, (1, 8), bound_of))


def bound(device, nbytes, ops, kind):
    """The least time the card could take: bytes over the data sheet's
    memory rate or operations over its ``kind`` rate, the larger."""
    t_bytes = nbytes / profiling.device_hbm_bandwidth(device) * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def score_bound(g, m, kind, planes=1):
    """Bound of one score pass at width m: the words, R and A moved once,
    ``planes`` x 2*n_pad*p*m operations."""
    nbytes = g.words.numel() * 4 + 4 * g.n_pad * m + 4 * g.p * m
    return bound(g.device, nbytes, planes * 2 * g.n_pad * g.p * m, kind)


def check_i8(g, m, gen):
    """Kernel 6 on the genotypes ``g`` (words_t built) at width m, bit for
    bit against its plain version and kernel 2's A on the same rhs; returns
    the rhs and the max abs error against plain (0)."""
    rhs = rhs_on(g, m, gen)
    got = kernels.xt_dots_T(g.words_t, rhs)[:g.p]
    ref = decode.xt_dots_T(g.words_t, rhs)[:g.p]
    k2 = kernels.xt_dots_words_t(g.words_t, rhs, want_missing=False,
                                 p=g.p)[0]
    sync()
    same_ref, same_k2 = torch.equal(got, ref), torch.equal(got, k2)
    abs_err = float((got - ref).abs().max())
    print(f"[kernel-i8] n={g.n} p={g.p} m={m} missing={g.has_missing}: "
          f"kernel 6 bit-equal to plain {same_ref}, to kernel 2's A "
          f"{same_k2}", flush=True)
    if not (same_ref and same_k2):
        raise AssertionError(f"kernel 6 at {g.n} x {g.p}, m={m}: equal to "
                             f"plain {same_ref}, to kernel 2's A {same_k2}")
    return rhs, abs_err


def phase_kernel_i8(small, g, gen):
    """Kernel 6 bit for bit against its plain version and kernel 2's A on
    the kernel cases and at full width, then timed beside its int8 bound."""
    for s in small:
        s.with_dual_layout()
        for m in (1, 8, 100):
            check_i8(s, m, gen)
        s.words_t = None
    times = {}
    for m in (1, 8, 100):
        rhs, abs_err = check_i8(g, m, gen)
        ms, plain_ms, runs = interleaved(
            lambda: kernels.xt_dots_T(g.words_t, rhs),
            lambda: decode.xt_dots_T(g.words_t, rhs),
            reps=20 if m == 1 else 10, plain_reps=PLAIN_REPS)
        times[m] = (ms, plain_ms, 0.0, abs_err)
        b = score_bound(g, m, "int8", planes=3)
        print(f"[kernel-i8] {g.n} x {g.p} m={m}: kernel {ms:.3f} ms (runs "
              f"{runs[0]:.3f}, {runs[1]:.3f}), plain {plain_ms:.3f} ms (runs "
              f"{runs[2]:.3f}, {runs[3]:.3f}), bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}), {b['bound_ms'] / ms:.3f} of it per X'R "
              "pass", flush=True)
    bound_of = lambda m: score_bound(g, m, "int8", 3)            # noqa: E731
    return dict(**errors(0.0, times), ms=times[100][0],
                plain_ms=times[100][1], m=100,
                **width_stats(times, (1, 8), bound_of),
                **bound_of(100), library_ms=None)


def phase_probe(g):
    c = torch.tensor([SEED], dtype=torch.int32, device=g.device)
    got, ref = kernels.read_words(g.words, c), decode.read_words(g.words, c)
    sync()
    if not torch.equal(got, ref):
        raise AssertionError(f"read probe {got.item()} != plain {ref.item()}")
    print(f"[probe] read_words {g.n} x {g.p}: kernel {got.item()} == plain",
          flush=True)
    kernels.LAUNCHES["read_words"] = 0
    roof = profiling.stream_bandwidth_kernel(g, iters=20)
    launches = kernels.LAUNCHES["read_words"]
    plain_rate = profiling.stream_bandwidth(g, iters=3)
    plain_ms = cuda_ms(lambda: decode.read_words(g.words, c), 3)
    sheet = profiling.device_hbm_bandwidth(g.device)
    ms = g.words.numel() * 4 / roof * 1e3
    print(f"[probe] read ceiling {roof / 1e9:.1f} GB/s ({ms:.3f} ms per "
          f"{g.words.numel() * 4 / 1e9:.2f} GB read, {roof / sheet:.3f} of "
          f"the data sheet's {sheet / 1e12:.2f} TB/s), {launches} launches; "
          f"plain sum {plain_ms:.3f} ms; plain stream_bandwidth "
          f"{plain_rate / 1e9:.1f} GB/s", flush=True)
    for layout in ("quad", "vt"):
        for m in (1, 100):
            r = profiling.kernel_roofline(g, m=m, iters=10 if m == 1 else 3,
                                          layout=layout, measured_roof=roof)
            print(f"[probe] kernel_roofline {layout} m={m}: "
                  f"{r['ms_per_pass']:.3f} ms, "
                  f"{r['packed_gbytes_per_s']:.1f} GB/s, "
                  f"{r['hbm_roofline_fraction']:.3f} of the data sheet, "
                  f"{r['measured_roofline_fraction']:.3f} of the read ceiling",
                  flush=True)
    library_ms = cuda_ms(lambda: torch.sum(g.words), 3)
    print(f"[probe] torch.sum of the words {library_ms:.3f} ms", flush=True)
    nbytes = g.words.numel() * 4
    return dict(launches=launches, max_abs_err=float((got - ref).abs().max()),
                ms=ms, plain_ms=plain_ms, gbytes_per_s=roof / 1e9,
                **bound(g.device, nbytes, g.words.numel(), "f32"),
                library_ms=library_ms)


def phase_parity(dev):
    n, p = N_PARITY, P_PARITY
    words, mu, inv_sd, hm, causal, beta = simulate_packed_problem(
        np.random.default_rng(3), n, p, k=K, missing=True)
    card_g, cpu_g = (PackedGenotypes.from_numpy(words, mu, inv_sd, n=n, p=p,
                                                has_missing=hm, device=d)
                     for d in (dev, "cpu"))
    y = phenotype(cpu_g, causal, beta, 4)
    a = fit_iht(y, card_g, k=K, verbose=False)
    b = fit_iht(y, cpu_g, k=K, verbose=False)
    sa, sb = set(np.flatnonzero(a.beta)), set(np.flatnonzero(b.beta))
    print(f"[parity] n={n} p={p} k={K}: cuda logl {a.logl} iter {a.iter}, "
          f"cpu logl {b.logl} iter {b.iter}, same support {sa == sb}",
          flush=True)
    # the card's score (dual layout) takes R through 21-bit digits, the
    # CPU's (quad words) f32: a scaled change at the tolerance may end one
    # fit an iteration before the other; the support must agree
    if sa != sb or abs(a.iter - b.iter) > 1:
        raise AssertionError("card and CPU fits disagree")
    if card_g.words_t is None:
        raise AssertionError("the card fit did not build the dual layout")
    return card_g, cpu_g, y


def phase_cv_parity(card_g, cpu_g, y):
    folds = np.random.default_rng(5).integers(1, 4, size=card_g.n)
    path = list(range(1, 11))
    kernels.LAUNCHES["xt_dots_words_t"] = 0
    a = cv_iht(y, card_g, path=path, q=3, folds=folds, verbose=False)
    launches = kernels.LAUNCHES["xt_dots_words_t"]
    b = cv_iht(y, cpu_g, path=path, q=3, folds=folds, verbose=False)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    ka, kb = path[int(np.argmin(a))], path[int(np.argmin(b))]
    print(f"[cv-parity] n={card_g.n} p={card_g.p} path 1:10 q=3: cuda best k "
          f"{ka}, cpu best k {kb}, mse rel err {err:.3g}, kernel-2 launches "
          f"{launches}", flush=True)
    if not err < CV_TOL or ka != kb or launches < 2:
        raise AssertionError("card and CPU cv disagree")


def phase_fit(g, causal, y, card, name="fit", warm=FIT_WARM, min_found=K,
              **fit_kw):
    """The 10k x 1M fit (``fit_kw``: its family, link, est_r) through both
    layouts, cold then ``warm`` warm runs each: exactly K selected, at
    least ``min_found`` causal SNPs among them; returns kernel 1's and
    kernel 2's launches in the last warm fit of each layout."""
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    res = {}
    for layout, x in (("quad", quad), ("dual", g)):
        mine = "xt_dots_words" if layout == "quad" else "xt_dots_words_t"
        other = "xt_dots_words_t" if layout == "quad" else "xt_dots_words"
        walls = []
        for run in range(1 + warm):
            for k in kernels.LAUNCHES:
                kernels.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            r = fit_iht(y, x, k=K, verbose=False, **fit_kw)
            walls.append(time.perf_counter() - t0)
            launches = dict(kernels.LAUNCHES)
            sel = np.flatnonzero(r.beta)
            found = len(set(sel) & set(causal.tolist()))
            if run == 0:
                print(f"[{name}] {layout} cold fit {N} x {P} k={K}: "
                      f"{walls[0]:.4f} s on {card}; iter {r.iter}, logl "
                      f"{r.logl}, causal recovered {found}/{K}, {len(sel)} "
                      f"selected, launches {launches[mine]} ({mine}), "
                      f"{launches[other]} ({other})", flush=True)
            if (len(sel) != K or found < min_found
                    or launches[mine] < r.iter + 1 or launches[other] != 0):
                raise AssertionError(f"{name}: {layout} fit failed its "
                                     "checks")
            if run:
                same = (set(sel), r.iter, r.logl) == res[layout][:3]
                if not same:
                    raise AssertionError(f"{name}: {layout} warm fit differs "
                                         "from cold")
            res[layout] = (set(sel), r.iter, r.logl, launches[mine])
        walls = np.array(walls[1:])
        print(f"[{name}] {layout} {warm} warm fits: median "
              f"{np.median(walls):.4f} s, range {walls.min():.4f}-"
              f"{walls.max():.4f} s, each the same result; launches "
              f"{launches[mine]} ({mine}) per fit", flush=True)
    (sq, iq, lq, quad_launches), (sd, idu, ld, dual_launches) = (
        res["quad"], res["dual"])
    # kernels 1 and 2 compute one function bit for bit, so the two fits
    # are one fit
    if (sq, iq, lq) != (sd, idu, ld):
        raise AssertionError(f"{name}: quad and dual fits differ: {iq} and "
                             f"{idu} iterations, logl {lq} and {ld}, same "
                             f"support {sq == sd}")
    print(f"[{name}] quad and dual: identical, support of {len(sq)}, {iq} "
          f"iterations, logl {lq}", flush=True)
    return quad_launches, dual_launches


@contextlib.contextmanager
def solver_states(module=univariate, name="run_iht", keep=lambda st: st):
    """Collects ``keep`` of the state that every call of ``module.name``
    returns: by default every full solve (``univariate.run_iht``; cv_iht's
    default path runs one for all its (fold, k) tasks);
    ``fit_module.finalize_iht`` gives the final state of every ``fit_iht``,
    ``mv.finalize_mv_iht`` that of every chunk of a multivariate cv."""
    states, fn = [], getattr(module, name)

    def recording(*args, **kwargs):
        st = fn(*args, **kwargs)
        states.append(keep(st))
        return st

    setattr(module, name, recording)
    try:
        yield states
    finally:
        setattr(module, name, fn)


def run_cv(x, y, **cv_kw):
    """cv_iht on its default path (``cv_kw``: its family, link, checkpoint
    and max_iter options): (mse, wall
    s, the launches of every kernel, counted from 0, the final solver
    state)."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    kw = dict(path=CV_PATH, q=CV_Q, verbose=False, max_iter=CV_MAX_ITER,
              rng=np.random.default_rng(SEED))
    with solver_states() as states:
        t0 = time.perf_counter()
        mse = cv_iht(y, x, **dict(kw, **cv_kw))
        wall = time.perf_counter() - t0
    return mse, wall, dict(kernels.LAUNCHES), states[-1]


def phase_cv(name, x, y, card, warm, kernel="xt_dots_words_t", gaussian=True,
             **cv_kw):
    """cv_iht at the full width on ``x`` (genotypes or an operator), cold
    then ``warm`` warm runs on the same folds, every score pass through
    ``kernel`` (kernel 2, or kernel 1 for the quad words) and none through
    the other; for the Gaussian cv (``gaussian``) also every task converged
    and best k in 8..14; returns its launches in the last run and the
    mse."""
    other = ({"xt_dots_words", "xt_dots_words_t"} - {kernel}).pop()
    k = "kernel-2" if kernel == "xt_dots_words_t" else "kernel-1"
    missing = (x.geno if isinstance(x, PackedOp) else x).has_missing
    out = []
    torch.cuda.reset_peak_memory_stats()
    for run in range(1 + warm):
        mse, wall, counts, st = run_cv(x, y, **cv_kw)
        launches = counts[kernel]
        iters, iteration = st.iters.cpu().numpy(), st.iteration
        del st                  # its (B, p) arrays would raise the next peak
        done = int((iters < CV_MAX_ITER).sum())
        best = CV_PATH[int(np.argmin(mse))]
        out.append((mse, wall))
        if (not np.all(np.isfinite(mse)) or launches < iteration + 1
                or counts[other] != 0
                or gaussian and (done != len(iters) or not 8 <= best <= 14)):
            raise AssertionError(f"{name} failed its checks: best k {best}, "
                                 f"{done}/{len(iters)} converged, "
                                 f"{launches} {k} launches, "
                                 f"{counts[other]} of {other}")
        if run and not np.array_equal(mse, out[0][0]):
            raise AssertionError(f"{name}: a warm run differs from the cold")
        if run == 0:
            print(f"[{name}] cold cv_iht {N} x {P} missing={missing} "
                  f"path 1:{CV_PATH[-1]} q={CV_Q}: {wall:.4f} s on {card}; "
                  f"{done}/{len(iters)} tasks converged, the last at "
                  f"iteration {iters.max()} ({iteration} iterations "
                  f"run); {k} launches {launches}; best k {best}",
                  flush=True)
            mse_s = np.array2string(mse, precision=6, max_line_width=400)
            print(f"[{name}] mse {mse_s}", flush=True)
    walls = np.array([w for _, w in out[1:]])
    print(f"[{name}] {warm} warm cvs: median {np.median(walls):.4f} s, range "
          f"{walls.min():.4f}-{walls.max():.4f} s, the same mse as the cold "
          f"run; {k} launches {launches} per cv", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{name}] peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    return launches, out[0][0]


def phase_cv_quad(g, y, card, dual_mse):
    """The cv of phase cv through the quad words (kernel 1), as every cv
    past the dual-layout budget runs: mse equal to the dual cv's bit for
    bit, best k 10; returns kernel 1's launches in the last run."""
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    launches, mse = phase_cv("cv-quad", quad, y, card, CVQ_WARM,
                             kernel="xt_dots_words")
    best = CV_PATH[int(np.argmin(mse))]
    equal = np.array_equal(mse, dual_mse)
    print(f"[cv-quad] mse equal to the dual cv's bit for bit {equal}; best k "
          f"{best}", flush=True)
    if not equal or best != 10 or launches < 2:
        raise AssertionError(f"the quad-word cv differs: equal {equal}, best "
                             f"k {best}, {launches} kernel-1 launches")
    return launches


def free_port():
    """A free TCP port on this machine, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def check_sharded_xtr(sop, quad, g, gen):
    """The sharded operator's xtr at m = 1 and 100 torch.equal to the
    single-device quad-word one (kernel 1 on the same words), one kernel-1
    launch a call, and kernel 1 on the shard's words bit for bit against
    its plain version."""
    words = sop.geno.words
    for m in (1, 100):
        R = rhs_on(g, m, gen).T.contiguous()
        reset_launches()
        got = sop.xtr(R)
        launched = kernels.LAUNCHES["xt_dots_words"]
        equal = torch.equal(got, quad.xtr(R))
        kw = dict(want_missing=g.has_missing, p=sop.p_local)
        plain = all(same(a, b) for a, b in zip(
            kernels.xt_dots_words(words, R.T, **kw),
            decode.xt_dots_words(words, R.T, **kw)) if a is not None)
        print(f"[sharded] world of 1 (NCCL): xtr at m={m} equal to the "
              f"quad-word PackedOp's {equal}, {launched} kernel-1 launch; "
              f"kernel 1 on the shard equal to its plain version {plain}",
              flush=True)
        if not (equal and plain and launched == 1):
            raise AssertionError(f"sharded: xtr at m={m} differs")


def sharded_world_of_one(g, y, card, dual_mse, gen):
    """The sharded code path in a world of one rank on NCCL, in this
    process: xtr, then the Gaussian fit and the cv through ShardedPackedOp
    against the quad-word PackedOp's, bit for bit, timed in turns
    (quad, sharded, sharded, quad, ...); returns (the quad-word fit and cv,
    kernel 1's launches in the sharded fit and cv)."""
    from mendeliht_tpu_torch.parallel import make_mesh, shard_geno_op
    from mendeliht_tpu_torch.parallel import multihost as mh

    quad = PackedOp(dataclasses.replace(g, words_t=None))
    mh.init_process_group(f"tcp://localhost:{free_port()}", world_size=1,
                          rank=0, backend="nccl", timeout=SHARD_TIMEOUT)
    try:
        sop = shard_geno_op(quad, make_mesh(1, 1, device=g.device))
        check_sharded_xtr(sop, quad, g, gen)
        calls = sop.mesh.calls
        runs, walls, launches = {}, {"quad": [], "sharded": []}, {}
        for run in range(1 + SHARD_FIT_WARM):
            order = (("quad", quad), ("sharded", sop))
            for name, x in order if run % 2 == 0 else order[::-1]:
                reset_launches()
                before = dict(calls)
                t0 = time.perf_counter()
                r = fit_iht(y, x, k=K, verbose=False)
                walls[name].append(time.perf_counter() - t0)
                if name == "sharded":
                    fit_calls = {k: calls[k] - before[k] for k in calls}
                runs.setdefault(name, r)
                if not same_fit(r, runs[name]):
                    raise AssertionError(f"sharded: a warm {name} fit "
                                         "differs from the cold one")
                launches[name] = dict(kernels.LAUNCHES)
        sq, ss = runs["quad"], runs["sharded"]
        fit_launch = launches["sharded"]["xt_dots_words"]
        equal = same_fit(ss, sq)
        print(f"[sharded] world of 1: fit {N} x {P} k={K} through "
              f"ShardedPackedOp equal to the quad-word fit bit for bit "
              f"{equal} (support of {np.count_nonzero(ss.beta)}, {ss.iter} "
              f"iterations, logl {ss.logl}); kernel-1 launches {fit_launch}, "
              f"quad {launches['quad']['xt_dots_words']}; collectives a "
              f"sharded fit {fit_calls}", flush=True)
        if (not equal or fit_launch < ss.iter + 1
                or launches["sharded"]["xt_dots_words_t"] != 0):
            raise AssertionError("sharded: the world-of-1 fit differs from "
                                 "the quad-word fit")
        print_turns("fit", walls, card)

        mses, walls, cv_launch = {}, {"quad": [], "sharded": []}, {}
        peak = {}
        for run in range(1 + SHARD_CV_WARM):
            order = (("quad", quad), ("sharded", sop))
            for name, x in order if run % 2 == 0 else order[::-1]:
                torch.cuda.reset_peak_memory_stats()
                before = dict(calls)
                mse, wall, counts, st = run_cv(x, y)
                del st
                if name == "sharded":
                    cv_calls = {k: calls[k] - before[k] for k in calls}
                walls[name].append(wall)
                peak[name] = torch.cuda.max_memory_allocated()
                if not np.array_equal(mse, dual_mse):
                    raise AssertionError(f"sharded: the {name} cv's mse "
                                         "differs from the dual cv's")
                mses[name] = mse
                cv_launch[name] = counts
        best = CV_PATH[int(np.argmin(mses["sharded"]))]
        cv_k1 = cv_launch["sharded"]["xt_dots_words"]
        print(f"[sharded] world of 1: cv path 1:{CV_PATH[-1]} q={CV_Q} "
              f"through ShardedPackedOp: mse equal to the quad-word and dual "
              f"cvs' bit for bit True, best k {best}; kernel-1 launches "
              f"{cv_k1}; collectives {cv_calls}; peak device memory "
              f"{peak['sharded'] / 2**30:.2f} GiB (quad "
              f"{peak['quad'] / 2**30:.2f} GiB)", flush=True)
        if cv_k1 < 2 or cv_launch["sharded"]["xt_dots_words_t"] != 0:
            raise AssertionError("sharded: the world-of-1 cv did not run "
                                 "kernel 1 alone")
        print_turns("cv", walls, card)
    finally:
        torch.distributed.destroy_process_group()
    return (sq, mses["quad"]), {"world1_fit": fit_launch,
                                "world1_cv": cv_k1}


def print_turns(what, walls, card):
    """The cold and warm walls of the quad-word and sharded runs taken in
    turns, and the warm medians' difference (the hooks' cost)."""
    med = {k: float(np.median(v[1:])) for k, v in walls.items()}
    print(f"[sharded] world of 1 on {card}: {what} cold quad "
          f"{walls['quad'][0]:.4f} s, sharded {walls['sharded'][0]:.4f} s; "
          f"warm (in turns) quad median {med['quad']:.4f} s (range "
          f"{min(walls['quad'][1:]):.4f}-{max(walls['quad'][1:]):.4f}), "
          f"sharded median {med['sharded']:.4f} s (range "
          f"{min(walls['sharded'][1:]):.4f}-{max(walls['sharded'][1:]):.4f});"
          f" sharded - quad {med['sharded'] - med['quad']:+.4f} s",
          flush=True)


def sharded_rank(rank, tmp):
    """One of SHARD_RANKS rank processes on the one card (gloo, the
    collectives staged through the host): this rank's SNP shard of
    ``tmp/flagship.bed`` by ``multihost.load_bed_shard``, then the fit
    (cold, warm) and the cv (cold, warm) through ShardedPackedOp; the
    results, walls, kernel-1 launches and peak memory to
    ``tmp/rank<rank>.json``."""
    from mendeliht_tpu_torch.parallel import ShardedPackedOp
    from mendeliht_tpu_torch.parallel import multihost as mh

    rank, dev = int(rank), torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mh.init_process_group("file://" + os.path.join(tmp, "init"),
                          world_size=SHARD_RANKS, rank=rank, backend="gloo",
                          timeout=SHARD_TIMEOUT)
    mesh = mh.make_global_mesh(n_task=1, n_snp=SHARD_RANKS, device=dev)
    t0 = time.perf_counter()
    geno, p_true = mh.load_bed_shard(os.path.join(tmp, "flagship"), mesh)
    sync()
    out = {"load_s": time.perf_counter() - t0, "p_local": geno.p,
           "p_true": p_true}
    y = np.load(os.path.join(tmp, "y.npy"))
    op = ShardedPackedOp(geno, mesh)
    walls = []
    for _ in range(1 + SHARD_RANK_WARM):
        reset_launches()
        before = dict(mesh.calls)
        t0 = time.perf_counter()
        r = fit_iht(y, op, k=K, verbose=False)
        walls.append(time.perf_counter() - t0)
    sel = np.flatnonzero(r.beta[:p_true])
    out["fit"] = dict(support=sel.tolist(), beta=r.beta[sel].tolist(),
                      c=r.c.tolist(), iter=r.iter, logl=r.logl, walls=walls,
                      launches=kernels.LAUNCHES["xt_dots_words"],
                      calls={k: v - before[k] for k, v in mesh.calls.items()})
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(1 + SHARD_RANK_WARM):
        reset_launches()
        before = dict(mesh.calls)
        t0 = time.perf_counter()
        mse = cv_iht(y, op, path=CV_PATH, q=CV_Q, verbose=False,
                     max_iter=CV_MAX_ITER, rng=np.random.default_rng(SEED))
        walls.append(time.perf_counter() - t0)
    out["cv"] = dict(mse=mse.tolist(), walls=walls,
                     launches=kernels.LAUNCHES["xt_dots_words"],
                     calls={k: v - before[k] for k, v in mesh.calls.items()},
                     peak=torch.cuda.max_memory_allocated(dev))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def sharded_two_ranks(g, y, card, quad_fit, quad_mse):
    """SHARD_RANKS rank processes on the one card over gloo, each reading
    its half of the genotypes' PLINK trio: the fit and cv against the
    single-device quad-word ones (the same support and best k, iterations
    within one, betas within SHARD_BETA_TOL, mse within SHARD_MSE_TOL
    relative), both ranks the same result, each rank's kernel-1 launches;
    returns those launches."""
    tmp = tempfile.mkdtemp(prefix="mendeliht_sharded_")
    procs = []
    try:
        t_write = write_trio(os.path.join(tmp, "flagship"), g, y)
        np.save(os.path.join(tmp, "y.npy"), y)
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [here, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.sharded_rank(*sys.argv[1:])", str(r), tmp],
            cwd=here, env=env) for r in range(SHARD_RANKS)]
        for pr in procs:
            pr.wait(timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        if any(pr.returncode != 0 for pr in procs):
            raise AssertionError("sharded: a rank process failed: exit codes "
                                 f"{[pr.returncode for pr in procs]}")
        res = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    sel = np.flatnonzero(quad_fit.beta)
    it, logl, beta = quad_fit.iter, quad_fit.logl, quad_fit.beta[sel]
    fit, cv = res[0]["fit"], res[0]["cv"]
    mse = np.asarray(cv["mse"])
    err = float(np.max(np.abs(mse - quad_mse) / np.abs(quad_mse)))
    beta_err = (float(np.max(np.abs(np.asarray(fit["beta"]) - beta)))
                if fit["support"] == sel.tolist() else float("inf"))
    best, qbest = (CV_PATH[int(np.argmin(v))] for v in (mse, quad_mse))
    agree = all(r["cv"]["mse"] == cv["mse"] and all(
        r["fit"][k] == fit[k] for k in ("support", "beta", "c", "iter",
                                        "logl")) for r in res)
    loads = ", ".join(f"{r['p_local']} SNPs in {r['load_s']:.2f} s"
                      for r in res)
    print(f"[sharded] {SHARD_RANKS} ranks on one card (gloo, host-staged "
          f"collectives): PLINK trio written in {t_write:.2f} s; ranks "
          f"started, loaded their shards ({loads}), fitted and "
          f"cross-validated in {wall:.1f} s", flush=True)
    print(f"[sharded] {SHARD_RANKS} ranks: fit support equal to the "
          f"quad-word fit's {fit['support'] == sel.tolist()}, iterations "
          f"{fit['iter']} (quad {it}), max|beta - quad| {beta_err:.3g}, "
          f"logl {fit['logl']} (quad {logl}); cv best k {best} (quad "
          f"{qbest}), mse max rel err {err:.3g}; both ranks the same "
          f"result {agree}", flush=True)
    for r, out in enumerate(res):
        print(f"[sharded] rank {r} on {card}: fit cold "
              f"{out['fit']['walls'][0]:.4f} s, warm "
              f"{min(out['fit']['walls'][1:]):.4f}-"
              f"{max(out['fit']['walls'][1:]):.4f} s, kernel-1 launches "
              f"{out['fit']['launches']}, collectives {out['fit']['calls']};"
              f" cv cold {out['cv']['walls'][0]:.4f} s, warm "
              f"{min(out['cv']['walls'][1:]):.4f}-"
              f"{max(out['cv']['walls'][1:]):.4f} s, kernel-1 launches "
              f"{out['cv']['launches']}, collectives {out['cv']['calls']}, "
              f"peak device memory {out['cv']['peak'] / 2**30:.2f} GiB",
              flush=True)
    if (fit["support"] != sel.tolist() or abs(fit["iter"] - it) > 1
            or not beta_err <= SHARD_BETA_TOL or best != qbest
            or not err <= SHARD_MSE_TOL or not agree
            or any(r["fit"]["launches"] < r["fit"]["iter"] + 1
                   or r["cv"]["launches"] < 2 for r in res)):
        raise AssertionError("sharded: the two-rank fit or cv differs from "
                             "the single-device one")
    return {"ranks2_fit": [r["fit"]["launches"] for r in res],
            "ranks2_cv": [r["cv"]["launches"] for r in res]}


def phase_sharded_profile(g, y, card):
    """Where the hooks' cost goes: a warm quad-word and a warm world-of-1
    sharded fit and cv, each traced (in a world of one rank on NCCL made
    again and warmed by one untraced fit; after the lab and the probe,
    whose ``device_ms`` needs whole traces, which lose kernel records more
    often the more profiler sessions ran before)."""
    from mendeliht_tpu_torch.parallel import make_mesh, shard_geno_op
    from mendeliht_tpu_torch.parallel import multihost as mh

    quad = PackedOp(dataclasses.replace(g, words_t=None))
    mh.init_process_group(f"tcp://localhost:{free_port()}", world_size=1,
                          rank=0, backend="nccl", timeout=SHARD_TIMEOUT)
    try:
        sop = shard_geno_op(quad, make_mesh(1, 1, device=g.device))
        fit_iht(y, sop, k=K, verbose=False)     # the new world's NCCL set-up
        phase_profile(g, y, card, calls=tuple(
            (f"{what} {name}", "xt_dots_t", call)
            for name, x in (("quad", quad), ("sharded (world of 1)", sop))
            for what, call in (
                ("fit", lambda x=x: fit_iht(y, x, k=K, verbose=False)),
                ("cv", lambda x=x: run_cv(x, y)))))
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded(g, y, card, dual_mse, gen):
    """The multi-GPU path (``mendeliht_tpu_torch.parallel``) on the one
    card: a world of one rank on NCCL, then SHARD_RANKS ranks over gloo;
    returns kernel 1's launches in each run."""
    t0 = time.perf_counter()
    (quad_fit, quad_mse), launches = sharded_world_of_one(g, y, card,
                                                          dual_mse, gen)
    launches.update(sharded_two_ranks(g, y, card, quad_fit, quad_mse))
    print(f"[sharded] phase wall {time.perf_counter() - t0:.1f} s; kernel-1 "
          f"launches {launches}", flush=True)
    return launches


def phase_profile(g, y, card, calls=None):
    """Where a warm cv's and a warm dual-layout fit's time goes (or that of
    ``calls``: (what, kernel name part, call))."""
    calls = calls or (
        ("cv", "xt_dots_t", lambda: run_cv(g, y)),
        ("fit", "xt_dots_t", lambda: fit_iht(y, g, k=K, verbose=False)))
    for what, kernel, call in calls:
        with profiling.trace() as s:
            call()
        print(f"[profile] warm {what} {N} x {P} on {card}: wall "
              f"{s['wall_ms']:.1f} ms, device busy {s['device_busy_ms']:.1f} "
              f"ms, idle share {s['idle_share']:.3f}; {s['device_ops']} device "
              f"ops, {s['launches']} kernel launches ({s['launch_host_ms']:.1f}"
              f" ms of host), {s['syncs']} syncs waiting "
              f"{s['sync_wait_ms']:.1f} ms", flush=True)
        for name, ms, count in s["kernels"]:
            print(f"[profile]   {ms:9.3f} ms {count:6d}x  {name[:110]}",
                  flush=True)
        if not (s["device_busy_ms"] > 0
                and any(kernel in name for name, _, _ in s["kernels"])):
            raise AssertionError(f"the {what} trace shows no {kernel} time")


def family_responses(g):
    """{family name: (y, causal SNPs)} of each family in FAMILY_SEEDS,
    drawn by ``simulate_random_response`` over ``g`` with seed SEED + its
    index there, through the link the families phase fits it with."""
    out = {}
    for i, dist in enumerate(FAMILY_SEEDS):
        _, d, l, _ = next(f for f in FAMILIES if f[1].name == dist)
        y, _, causal = simulate_random_response(
            g, K, d, l, rng=np.random.default_rng(SEED + i))
        out[dist] = (y, causal)
    return out


def phase_family_parity(card_g, cpu_g):
    """Every family of FAMILIES fitted on the card and on the CPU at the
    parity size: the same support, iterations within one; then the
    Bernoulli cv (path 1:10, q=3, fixed folds): mse within CV_TOL, the
    same best k."""
    t_phase = time.perf_counter()
    ys = family_responses(cpu_g)
    for label, d, l, est_r in FAMILIES:
        y, causal = ys[d.name]
        t0 = time.perf_counter()
        a = fit_iht(y, card_g, k=K, d=d, l=l, est_r=est_r, verbose=False)
        t1 = time.perf_counter()
        b = fit_iht(y, cpu_g, k=K, d=d, l=l, est_r=est_r, verbose=False)
        t2 = time.perf_counter()
        sa, sb = set(np.flatnonzero(a.beta)), set(np.flatnonzero(b.beta))
        print(f"[parity] {label} n={card_g.n} p={card_g.p} k={K}: cuda logl "
              f"{a.logl} iter {a.iter}, cpu logl {b.logl} iter {b.iter}, "
              f"same support {sa == sb}, causal recovered "
              f"{len(sa & set(causal.tolist()))}/{K}; {t1 - t0:.1f} s on "
              f"the card, {t2 - t1:.1f} s on the CPU", flush=True)
        if sa != sb or abs(a.iter - b.iter) > 1:
            raise AssertionError(f"{label}: card and CPU fits disagree")
    y = ys["bernoulli"][0]
    folds = np.random.default_rng(5).integers(1, 4, size=card_g.n)
    path = list(range(1, 11))
    kw = dict(d=Bernoulli(), path=path, q=3, folds=folds, verbose=False)
    a, b = cv_iht(y, card_g, **kw), cv_iht(y, cpu_g, **kw)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    ka, kb = path[int(np.argmin(a))], path[int(np.argmin(b))]
    print(f"[cv-parity] bernoulli n={card_g.n} p={card_g.p} path 1:10 q=3: "
          f"cuda best k {ka}, cpu best k {kb}, mse rel err {err:.3g}",
          flush=True)
    if not err < CV_TOL or ka != kb:
        raise AssertionError("card and CPU Bernoulli cv disagree")
    print(f"[parity] families in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_families(g, card):
    """Every other GLM family at 10k x 1M on the card: the Bernoulli fit
    through both layouts (identical), the Bernoulli cv on cv_iht's default
    path, then the Poisson, negative binomial (est_r Newton and MM), Gamma
    and inverse Gaussian fits on the dual layout, each with exactly K
    selected and a finite logl, and a ``profiling.trace`` of a warm fit of
    every family; returns the score kernels' launches on each path."""
    t_phase = time.perf_counter()
    ys = family_responses(g)
    print(f"[families] responses of {len(ys)} families over {N} x {P} from "
          f"simulate_random_response in {time.perf_counter() - t_phase:.1f} "
          "s", flush=True)
    label, d, l, _ = FAMILIES[0]
    y, causal = ys[d.name]
    quad, dual = phase_fit(g, causal, y, card, name=f"families {label}",
                           warm=FAM_FIT_WARM, min_found=0, d=d, l=l)
    cv, _ = phase_cv(f"families {label} cv", g, y, card, FAM_CV_WARM,
                     gaussian=False, d=d, l=l)
    launches = {"xt_dots_words": {f"{label} quad fit": quad},
                "xt_dots_words_t": {f"{label} fit": dual, f"{label} cv": cv}}
    for label, d, l, est_r in FAMILIES:
        y, causal = ys[d.name]
        kw = dict(k=K, d=d, l=l, est_r=est_r, verbose=False)
        walls = []
        for _ in range(2):                          # cold, then warm
            for name in kernels.LAUNCHES:
                kernels.LAUNCHES[name] = 0
            with solver_states(fit_module, "finalize_iht") as states:
                t0 = time.perf_counter()
                r = fit_iht(y, g, **kw)
                walls.append(time.perf_counter() - t0)
            counts = dict(kernels.LAUNCHES)
        nb_r = float(states[-1].nb_r[0])
        sel = np.flatnonzero(r.beta)
        found = len(set(sel) & set(causal.tolist()))
        with profiling.trace() as s:
            fit_iht(y, g, **kw)
        print(f"[families] {label} ({l!r}, est_r={est_r}) {N} x {P} k={K} "
              f"on {card}: iter {r.iter}, logl {r.logl}, causal recovered "
              f"{found}/{K}, {len(sel)} selected, r {nb_r}; cold "
              f"{walls[0]:.4f} s, warm {walls[1]:.4f} s; kernel-2 launches "
              f"{counts['xt_dots_words_t']}; traced warm fit: wall "
              f"{s['wall_ms']:.1f} ms, device busy {s['device_busy_ms']:.1f} "
              f"ms, idle share {s['idle_share']:.3f}, {s['launches']} kernel "
              f"launches ({s['launch_host_ms']:.1f} ms of host), "
              f"{s['syncs']} syncs waiting {s['sync_wait_ms']:.1f} ms",
              flush=True)
        # one score pass at the start and one an iteration run; a fit that
        # does not converge reports max_iter after max_iter - 1 iterations
        ran = min(r.iter, FIT_MAX_ITER - 1)
        if (len(sel) != K or not np.isfinite(r.logl)
                or counts["xt_dots_words_t"] < ran + 1
                or counts["xt_dots_words"] != 0):
            raise AssertionError(f"the {label} fit failed its checks")
        launches["xt_dots_words_t"].setdefault(f"{label} fit",
                                               counts["xt_dots_words_t"])
    print(f"[families] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def option_cases(g, y, yb, seed):
    """(label, response, fit_iht keywords) of each fit option the options
    and parity phases run on ``g``: the debiased Gaussian and Bernoulli
    fits, the group fit (N_GROUPS groups of consecutive SNPs, at most
    GROUP_J of GROUP_K SNPs each) and the weighted fit (``maf_weights``)
    with an intercept and a covariate of which only the intercept is pinned
    (``zkeep``; covariate N(0, 1) from ``seed``)."""
    group = np.repeat(np.arange(1, N_GROUPS + 1), -(-g.p // N_GROUPS))[:g.p]
    z = np.stack([np.ones(g.n),
                  np.random.default_rng(seed).standard_normal(g.n)], axis=1)
    return (("debias", y, dict(debias=True)),
            ("debias bernoulli", yb, dict(debias=True, d=Bernoulli(),
                                          l=LogitLink())),
            ("group", y, dict(group=group, J=GROUP_J, k=GROUP_K)),
            ("weight zkeep", y, dict(z=z, weight=maf_weights(g),
                                     zkeep=[True, False])))


def check_option_fit(label, r, kw):
    """The selection an option promises: exactly K (SNPs and unpinned
    covariates), or with groups at most GROUP_J groups of at most GROUP_K
    SNPs, some selected; a finite logl."""
    sel = np.flatnonzero(r.beta)
    if "group" in kw:
        groups, counts = np.unique(kw["group"][sel], return_counts=True)
        ok = 0 < len(sel) and len(groups) <= GROUP_J and counts.max() <= GROUP_K
    else:
        free = ~np.asarray(kw.get("zkeep", [True] * len(r.c)))
        ok = len(sel) + int((r.c[free] != 0).sum()) == K
    if not (ok and np.isfinite(r.logl)):
        raise AssertionError(f"the {label} fit failed its checks: "
                             f"{len(sel)} selected, logl {r.logl}")
    return sel


def phase_option_parity(card_g, cpu_g, y):
    """Every fit option on the card and on the CPU at the parity size: the
    init_beta fit and the fits of ``option_cases``, the same support and
    iterations within one; then the init_beta cv (path 1:10, q=3, fixed
    folds), mse within CV_TOL and the same best k."""
    t_phase = time.perf_counter()
    yb, _, _ = simulate_random_response(cpu_g, K, Bernoulli(), LogitLink(),
                                        rng=np.random.default_rng(SEED))
    cases = (("init_beta", y, dict(init_beta=True)),
             *option_cases(cpu_g, y, yb, SEED + 11))
    for label, yy, kw in cases:
        kw = {"k": K, **kw}
        a = fit_iht(yy, card_g, verbose=False, **kw)
        b = fit_iht(yy, cpu_g, verbose=False, **kw)
        check_option_fit(label, a, kw)
        sa, sb = set(np.flatnonzero(a.beta)), set(np.flatnonzero(b.beta))
        print(f"[parity] option {label} n={card_g.n} p={card_g.p}: cuda logl "
              f"{a.logl} iter {a.iter}, cpu logl {b.logl} iter {b.iter}, "
              f"{len(sa)} selected, same support {sa == sb}", flush=True)
        if sa != sb or abs(a.iter - b.iter) > 1:
            raise AssertionError(f"option {label}: card and CPU fits "
                                 "disagree")
    folds = np.random.default_rng(5).integers(1, 4, size=card_g.n)
    path = list(range(1, 11))
    kw = dict(path=path, q=3, folds=folds, verbose=False, init_beta=True)
    a, b = cv_iht(y, card_g, **kw), cv_iht(y, cpu_g, **kw)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    ka, kb = path[int(np.argmin(a))], path[int(np.argmin(b))]
    print(f"[cv-parity] init_beta n={card_g.n} p={card_g.p} path 1:10 q=3: "
          f"cuda best k {ka}, cpu best k {kb}, mse rel err {err:.3g}",
          flush=True)
    if not err < CV_TOL or ka != kb:
        raise AssertionError("card and CPU init_beta cv disagree")
    print(f"[parity] options in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_options(g, causal, y, card):
    """The fit options at 10k x 1M on the card: the init_beta fit through
    both layouts (identical, causal recovered), the init_beta cv on the cv
    phase's folds, then the fits of ``option_cases`` on the dual layout,
    each cold and warm with its selection checked, and a
    ``profiling.trace`` of a warm init_beta cv and a warm debiased fit;
    returns the score kernels' launches on each option's path."""
    t_phase = time.perf_counter()
    quad, dual = phase_fit(g, causal, y, card, name="options init_beta",
                           warm=OPT_FIT_WARM, init_beta=True)
    cv, _ = phase_cv("options init_beta cv", g, y, card, OPT_CV_WARM,
                     init_beta=True)
    launches = {"xt_dots_words": {"init_beta quad fit": quad},
                "xt_dots_words_t": {"init_beta fit": dual,
                                    "init_beta cv": cv}}
    yb, _, causal_b = simulate_random_response(
        g, K, Bernoulli(), LogitLink(), rng=np.random.default_rng(SEED))
    for label, yy, kw in option_cases(g, y, yb, SEED + 11):
        kw = {"k": K, **kw}
        walls = []
        for _ in range(2):                          # cold, then warm
            for name in kernels.LAUNCHES:
                kernels.LAUNCHES[name] = 0
            t0 = time.perf_counter()
            r = fit_iht(yy, g, verbose=False, **kw)
            walls.append(time.perf_counter() - t0)
            counts = dict(kernels.LAUNCHES)
        sel = check_option_fit(label, r, kw)
        truth = causal_b if "d" in kw else causal
        found = len(set(sel) & set(truth.tolist()))
        ran = min(r.iter, FIT_MAX_ITER - 1)
        print(f"[options] {label} fit {N} x {P} on {card}: iter {r.iter}, "
              f"logl {r.logl}, {len(sel)} selected, causal recovered "
              f"{found}/{K}; cold {walls[0]:.4f} s, warm {walls[1]:.4f} s; "
              f"kernel-2 launches {counts['xt_dots_words_t']}", flush=True)
        if (counts["xt_dots_words_t"] < ran + 1
                or counts["xt_dots_words"] != 0
                or label == "debias" and found != K):
            raise AssertionError(f"the {label} fit failed its checks")
        launches["xt_dots_words_t"][f"{label} fit"] = \
            counts["xt_dots_words_t"]
    phase_profile(g, y, card, calls=(
        ("init_beta cv", "xt_dots_t", lambda: run_cv(g, y, init_beta=True)),
        ("debiased fit", "xt_dots_t",
         lambda: fit_iht(y, g, k=K, debias=True, verbose=False))))
    print(f"[options] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def mv_response(g, r, rng, k_causal=10, scale=0.5):
    """The JAX package's flagship mv response (``bench.py::_mv_response``)
    through the port: ``k_causal`` causal SNPs shared by the ``r`` traits,
    effects N(0, scale^2), B X by ``PackedOp.forward_sel_multi`` on the
    genotypes' device, plus noise of covariance ``random_covariance_matrix``;
    returns (Y (r, n), the causal SNPs)."""
    causal = rng.choice(g.p, size=k_causal, replace=False)
    beta = rng.standard_normal((r, k_causal)) * scale
    idx = torch.as_tensor(causal[None, :], device=g.device)
    coef = torch.as_tensor(beta[None], dtype=torch.float32, device=g.device)
    bx = PackedOp(g).forward_sel_multi(idx, coef,
                                       torch.ones_like(coef[:, 0]))
    bx = bx[0, :, :g.n].cpu().double().numpy()
    sigma = random_covariance_matrix(r, rng=rng)
    noise = np.linalg.cholesky(sigma) @ rng.standard_normal((r, g.n))
    return np.ascontiguousarray(bx + noise), causal


def mv_entries(r):
    """The (trait, SNP) support of a multivariate result."""
    return set(zip(*map(list, np.nonzero(r.beta))))


def trace_text(s):
    return (f"wall {s['wall_ms']:.1f} ms, device busy "
            f"{s['device_busy_ms']:.1f} ms, idle share {s['idle_share']:.3f}; "
            f"{s['launches']} kernel launches ({s['launch_host_ms']:.1f} ms "
            f"of host), {s['syncs']} syncs waiting {s['sync_wait_ms']:.1f} ms")


def mv_fit_traced(Y, g, **kw):
    """``fit_iht`` of the mv response Y on ``g`` with its line searches
    recorded: (result, one [logl before, the full step's logl, backtracks]
    an iteration)."""
    rows, need = [], mv._mv_bt_need

    def recording(act, old_logl, cur, n_bt, max_step):
        out = need(act, old_logl, cur, n_bt, max_step)
        if not bool(n_bt.any()):                 # an iteration's first check
            rows.append([float(old_logl[0]), float(cur["logl"][0]), 0])
        rows[-1][2] += int(out.any())
        return out

    mv._mv_bt_need = recording
    try:
        return fit_iht(Y, g, **kw), rows
    finally:
        mv._mv_bt_need = need


def f32_ulps(a, b):
    """|a - b| in f32 roundings of b (0 where they are equal, as the -inf
    loglikelihood before a first iteration)."""
    if a == b:
        return 0.0
    return abs(a - b) / float(np.spacing(np.float32(abs(b))))


def mv_trace_check(label, a_rows, b_rows, a_iter, b_iter):
    """Holds two traced mv fits (card a, CPU b) to one trajectory: the
    loglikelihood before every common iteration up to the first whose
    backtracks differ (the split) within MV_LOGL_ULPS f32 roundings; and
    where the iteration counts differ by more than one, at most
    MV_ITER_SPREAD, the split a tie (on both devices the full step's
    loglikelihood within MV_LOGL_ULPS roundings of the one before, so the
    rounding of two f32 sums decides the backtrack).  Prints both traces
    from three iterations before the split."""
    split = next((i for i, (u, v) in enumerate(zip(a_rows, b_rows))
                  if u[2] != v[2]), min(len(a_rows), len(b_rows)))
    drift = max((f32_ulps(u[0], v[0]) for u, v in
                 zip(a_rows[:split + 1], b_rows[:split + 1])), default=0.0)
    tie = split < min(len(a_rows), len(b_rows)) and all(
        f32_ulps(r[split][1], r[split][0]) <= MV_LOGL_ULPS
        for r in (a_rows, b_rows))
    for i in range(max(0, split - 3), max(len(a_rows), len(b_rows))):
        cells = [" / ".join(f"{x}" for x in r[i]) if i < len(r) else "-"
                 for r in (a_rows, b_rows)]
        print(f"[mv-parity] {label} iteration {i + 1} (logl before / full "
              f"step / backtracks): cuda {cells[0]}; cpu {cells[1]}",
              flush=True)
    print(f"[mv-parity] {label}: split at iteration {split + 1}, logl "
          f"before each iteration up to it at most {drift:.0f} f32 roundings "
          f"apart, a tie there {tie}", flush=True)
    spread = abs(a_iter - b_iter)
    if drift > MV_LOGL_ULPS or spread > MV_ITER_SPREAD or (
            spread > 1 and not tie):
        raise AssertionError(f"mv {label}: card and CPU trajectories differ "
                             f"({a_iter} against {b_iter} iterations)")


def mv_diff(a, b):
    """(the same (trait, SNP) support, logl f32 roundings apart, B and Sigma
    rel err of b's max) of two mv results."""
    err_b, err_s = (float(np.abs(u - v).max() / np.abs(v).max())
                    for u, v in ((a.beta, b.beta), (a.Sigma, b.Sigma)))
    return mv_entries(a) == mv_entries(b), f32_ulps(a.logl, b.logl), err_b, \
        err_s


def mv_diff_text(diff):
    same, ulps, err_b, err_s = diff
    return (f"same support {same}, logl {ulps:.0f} f32 roundings apart, B "
            f"rel err {err_b:.3g}, Sigma rel err {err_s:.3g}")


def mv_agree(diff):
    same, ulps, err_b, err_s = diff
    return (same and ulps <= MV_LOGL_ULPS and err_b < MV_B_TOL
            and err_s < MV_SIGMA_TOL)


def phase_mv_parity(card_g, cpu_g):
    """The multivariate fit (3 traits, k = MV_K, plain and with
    init_beta) on the card and on the CPU at the parity size, each line
    search traced: the same (trait, SNP) support, the same loglikelihood
    plateau (MV_LOGL_ULPS), B within MV_B_TOL and Sigma within
    MV_SIGMA_TOL, one trajectory (``mv_trace_check``), and the CPU fit
    with a known fault (the score without Gamma) outside those bounds; then
    the mv cv (path 2:2:20, q=3, fixed folds): mse within CV_TOL, the same
    best k."""
    t_phase = time.perf_counter()
    Y, _ = mv_response(cpu_g, MV_TRAITS, np.random.default_rng(SEED + 31))
    for label, kw in (("plain", {}), ("init_beta", dict(init_beta=True))):
        kw = dict(k=MV_K, d=MvNormal(), verbose=False, **kw)
        (a, a_rows), (b, b_rows) = (mv_fit_traced(Y, x, **kw)
                                    for x in (card_g, cpu_g))
        diff = mv_diff(a, b)
        print(f"[mv-parity] {label} fit n={card_g.n} p={card_g.p} r="
              f"{MV_TRAITS} k={MV_K}: cuda logl {a.logl} iter {a.iter}, cpu "
              f"logl {b.logl} iter {b.iter}; {mv_diff_text(diff)}",
              flush=True)
        if not mv_agree(diff):
            raise AssertionError(f"mv {label}: card and CPU fits disagree")
        mv_trace_check(label, a_rows, b_rows, a.iter, b.iter)
        # the comparison's room against a fault: the CPU fit with the score
        # left without Gamma must fail it
        score = mv._score_mv
        mv._score_mv = lambda op, data, gamma, resid: score(
            op, data, torch.eye(gamma.shape[-1], dtype=gamma.dtype)
            .expand_as(gamma).contiguous(), resid)
        try:
            f = fit_iht(Y, cpu_g, **kw)
        finally:
            mv._score_mv = score
        fault = mv_diff(f, b)
        print(f"[mv-parity] {label} fault reading, the CPU fit with the score "
              f"without Gamma: iter {f.iter}; {mv_diff_text(fault)}",
              flush=True)
        if mv_agree(fault):
            raise AssertionError(f"mv {label}: the comparison passes a score "
                                 "without Gamma")
    folds = np.random.default_rng(5).integers(1, 4, size=card_g.n)
    kw = dict(path=MV_PARITY_PATH, q=3, folds=folds, verbose=False)
    kernels.LAUNCHES["xt_dots_words_t"] = 0
    a = cv_iht(Y, card_g, **kw)
    launches = kernels.LAUNCHES["xt_dots_words_t"]
    b = cv_iht(Y, cpu_g, **kw)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    ka = MV_PARITY_PATH[int(np.argmin(a))]
    kb = MV_PARITY_PATH[int(np.argmin(b))]
    print(f"[mv-parity] cv n={card_g.n} p={card_g.p} path 2:2:20 q=3: cuda "
          f"best k {ka}, cpu best k {kb}, mse rel err {err:.3g}, kernel-2 "
          f"launches {launches}; phase in {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    if not err < CV_TOL or ka != kb or launches < 2:
        raise AssertionError("card and CPU mv cv disagree")


def run_mv_cv(g, Y, traced=None):
    """The flagship mv cv on ``g`` (folds from ``default_rng(5)``): (mse,
    wall s, launches of every kernel from 0, each chunk's (T, iters,
    iterations run)); with ``traced`` (a dict) its first chunk runs inside
    ``profiling.trace``, whose summary and score launches fill it."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    solve = mv.cv_mv

    def first_chunk_traced(*args, **kwargs):
        if traced is None or traced:
            return solve(*args, **kwargs)
        before = kernels.LAUNCHES["xt_dots_words_t"]
        with profiling.trace() as s:
            out = solve(*args, **kwargs)
        traced.update(s, score_launches=kernels.LAUNCHES["xt_dots_words_t"]
                      - before)
        return out

    mv.cv_mv = first_chunk_traced
    try:
        with solver_states(mv, "finalize_mv_iht", keep=lambda st: (
                int(st.iters.shape[0]), st.iters.cpu().numpy(),
                st.iteration)) as chunks:
            t0 = time.perf_counter()
            mse = cv_iht(Y, g, path=MV_PATH, q=MV_Q, d=MvNormal(),
                         init_beta=True, min_iter=MV_MIN_ITER,
                         rng=np.random.default_rng(5), verbose=False)
            wall = time.perf_counter() - t0
    finally:
        mv.cv_mv = solve
    return mse, wall, dict(kernels.LAUNCHES), chunks


def phase_mv(g, card, gen):
    """The JAX package's flagship multivariate protocol at 10k x 1M: the
    3-trait fit (k = MV_K, init_beta, min_iter 10) through both layouts,
    cold then MV_FIT_WARM warm runs each (identical support, iterations
    and logl; exactly MV_K entries; causal SNP columns recovered), then the
    UKBB-protocol cv (path 100:100:1000, q = 3, init_beta, min_iter 10),
    cold then MV_CV_WARM warm runs on the same folds (two chunks of 15
    tasks, score passes at m = 45; best k, iterations, peak memory), and a
    ``profiling.trace`` of a warm fit and of the first chunk of a warm cv;
    kernels 1 and 2 first held to plain at the path's widths (MV_WIDTHS);
    returns the score kernels' launches on each path and their fields at
    those widths."""
    t_phase = time.perf_counter()
    widths = paired_widths("mv", g, gen, MV_WIDTHS, "_mv")
    Y, causal = mv_response(g, MV_TRAITS, np.random.default_rng(31))
    kw = dict(k=MV_K, d=MvNormal(), init_beta=True, min_iter=MV_MIN_ITER,
              verbose=False)
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    res = {}
    for layout, x in (("quad", quad), ("dual", g)):
        mine = "xt_dots_words" if layout == "quad" else "xt_dots_words_t"
        other = "xt_dots_words_t" if layout == "quad" else "xt_dots_words"
        walls = []
        for run in range(1 + MV_FIT_WARM):
            for name in kernels.LAUNCHES:
                kernels.LAUNCHES[name] = 0
            t0 = time.perf_counter()
            r = fit_iht(Y, x, **kw)
            walls.append(time.perf_counter() - t0)
            launches = dict(kernels.LAUNCHES)
            cols = set(np.flatnonzero(r.beta.any(axis=0)).tolist())
            found = len(cols & set(causal.tolist()))
            got = (mv_entries(r), r.iter, r.logl, launches[mine])
            if run == 0:
                print(f"[mv] {layout} cold fit {N} x {P} r={MV_TRAITS} "
                      f"k={MV_K} init_beta: {walls[0]:.4f} s on {card}; iter "
                      f"{r.iter}, logl {r.logl}, {len(got[0])} entries in "
                      f"{len(cols)} SNP columns, causal SNP columns recovered "
                      f"{found}/{len(causal)}, launches {launches[mine]} "
                      f"({mine}), {launches[other]} ({other})", flush=True)
            if (len(got[0]) != MV_K or not np.isfinite(r.logl)
                    or launches[mine] < r.iter + 1 or launches[other] != 0
                    or run and got != res[layout]):
                raise AssertionError(f"mv: the {layout} fit failed its "
                                     "checks")
            res[layout] = got
        walls = np.array(walls[1:])
        print(f"[mv] {layout} {MV_FIT_WARM} warm fits: median "
              f"{np.median(walls):.4f} s, range {walls.min():.4f}-"
              f"{walls.max():.4f} s, each the same result", flush=True)
    if res["quad"][:3] != res["dual"][:3]:
        raise AssertionError("mv: quad and dual fits differ")
    print(f"[mv] quad and dual fits identical: {res['dual'][1]} iterations, "
          f"logl {res['dual'][2]}", flush=True)

    # cv_mv_iht's default task chunk, the JAX package's budget: 15 at
    # 3 traits x 1M SNPs, so two chunks of the 30 tasks
    per_chunk = max(1, int(6e9 / (32.0 * MV_TRAITS * g.p * 4.0)))
    n_tasks = MV_Q * len(MV_PATH)
    sizes = [min(per_chunk, n_tasks - lo)
             for lo in range(0, n_tasks, per_chunk)]
    torch.cuda.reset_peak_memory_stats()
    first = None
    for run in range(1 + MV_CV_WARM):
        mse, wall, counts, chunks = run_mv_cv(g, Y)
        launches = counts["xt_dots_words_t"]
        best = MV_PATH[int(np.argmin(mse))]
        iters = np.concatenate([it for _, it, _ in chunks])
        text = ", ".join(f"{t} tasks, {ran} iterations run, "
                         f"{int((it < CV_MAX_ITER).sum())} converged"
                         for t, it, ran in chunks)
        if (not np.all(np.isfinite(mse)) or [t for t, _, _ in chunks]
                != sizes or counts["xt_dots_words"] != 0
                or launches < sum(ran + 1 for _, _, ran in chunks)
                or run and not np.array_equal(mse, first)):
            raise AssertionError(f"the mv cv failed its checks: chunks "
                                 f"{text}, {launches} kernel-2 launches")
        print(f"[mv] {'cold' if run == 0 else 'warm'} cv_iht {N} x {P} "
              f"r={MV_TRAITS} path {MV_PATH[0]}:{MV_PATH[1] - MV_PATH[0]}:"
              f"{MV_PATH[-1]} q={MV_Q} init_beta: "
              f"{wall:.4f} s on {card}; chunks: {text}; iterations per task "
              f"{int(iters.min())}-{int(iters.max())}; kernel-2 launches "
              f"{launches}; best k {best}", flush=True)
        if run == 0:
            first = mse
            mse_s = np.array2string(mse, precision=6, max_line_width=400)
            print(f"[mv] cv mse {mse_s}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[mv] cv peak device memory {peak / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)", flush=True)

    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    with profiling.trace() as s:
        fit_iht(Y, g, **kw)
    print(f"[mv] traced warm fit on {card}: {trace_text(s)}; kernel-2 "
          f"launches {kernels.LAUNCHES['xt_dots_words_t']}", flush=True)
    chunk = {}
    run_mv_cv(g, Y, traced=chunk)
    print(f"[mv] traced first chunk of a warm cv ({sizes[0]} tasks) on "
          f"{card}: {trace_text(chunk)}; kernel-2 launches "
          f"{chunk['score_launches']}", flush=True)
    for name, ms, count in chunk["kernels"]:
        print(f"[mv]   {ms:9.3f} ms {count:6d}x  {name[:110]}", flush=True)
    print(f"[mv] phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ({"xt_dots_words": {"mv quad fit": res["quad"][3]},
             "xt_dots_words_t": {"mv fit": res["dual"][3],
                                 "mv cv": launches}}, widths)


def reset_launches():
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0


def write_trio(prefix, g, y):
    """A PLINK trio of genotypes g: the ``.bed`` from their words through
    the port's packer (``write_plink_bed``, a chunk of SNPs at a time on
    their device), ``.bim`` / ``.fam`` by ``make_bim_fam_files`` with y
    ((n,) or (n, traits)) from ``.fam`` column 6; returns the seconds."""
    t0 = time.perf_counter()
    write_plink_bed(prefix + ".bed", g)
    make_bim_fam_files(g, y, prefix)
    return time.perf_counter() - t0


def same_genotypes(a, b):
    """Words and per-SNP stats bit for bit, on any devices."""
    return (torch.equal(a.words.cpu(), b.words.cpu())
            and torch.equal(a.mu.cpu(), b.mu.cpu())
            and torch.equal(a.inv_sd.cpu(), b.inv_sd.cpu())
            and a.has_missing == b.has_missing)


def timed_read(prefix, dev):
    """``read_plink`` on ``dev``, its wall split: the ``.bed`` file read
    (``_bed_payload`` alone), the upload of the payload in the repack's
    chunks (alone, synchronised), the upload and repack together
    (``from_bed_bytes`` alone), and the whole call; returns (SnpData,
    {part: s})."""
    t0 = time.perf_counter()
    payload, n, p = plink._bed_payload(prefix)
    t_read = time.perf_counter() - t0
    rows = payload.reshape(p, -1)
    t0 = time.perf_counter()
    for lo in range(0, p, snparray._CHUNK_P):
        torch.from_numpy(rows[lo:lo + snparray._CHUNK_P]).to(dev)
    sync_on(dev)
    t_upload = time.perf_counter() - t0
    t0 = time.perf_counter()
    PackedGenotypes.from_bed_bytes(payload, n, p, device=dev)
    sync_on(dev)
    t_repack = time.perf_counter() - t0
    del payload, rows
    t0 = time.perf_counter()
    snp = read_plink(prefix, device=dev)
    sync_on(dev)
    t_all = time.perf_counter() - t0
    return snp, {"file read": t_read, "upload": t_upload,
                 "upload + repack": t_repack, "read_plink": t_all}


def sync_on(dev):
    if torch.device(dev).type == "cuda":
        sync()


def phase_io(g, y, dual_mse, card, dev):
    """The file-level API at 10k x 1M: a PLINK trio written from the card
    words, ``read_plink`` on the card (the words and stats bit-equal to
    ``g``'s, its wall split), ``HostStreamedGenotypes.from_plink`` of it
    (bit-equal to ``read_plink``'s), ``iht`` from it against ``fit_iht`` in memory
    (bit-equal), ``cross_validate`` against phase 9's mse (bit-equal),
    the 3-trait ``iht`` with its covariance file against ``fit_iht``; then
    at IO_N x P_PARITY with missing calls the card's read equal to the
    CPU's; returns kernel 2's launches on each path."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mendeliht_io_")
    launches = {}
    try:
        prefix = os.path.join(tmp, "flagship")
        t_write = write_trio(prefix, g, y)
        Y, _ = mv_response(g, MV_TRAITS, np.random.default_rng(31))
        prefix2 = os.path.join(tmp, "flagship_mv")
        os.link(prefix + ".bed", prefix2 + ".bed")
        make_bim_fam_files(g, Y.T, prefix2)
        print(f"[io] wrote the PLINK trio of {N} x {P} "
              f"({os.path.getsize(prefix + '.bed') / 1e9:.3f} GB .bed) in "
              f"{t_write:.2f} s", flush=True)
        snp, parts = timed_read(prefix, dev)
        same = same_genotypes(snp.snparray, g)
        print(f"[io] read_plink on {card}: words and mu / inv_sd equal to "
              f"the card genotypes' bit for bit {same}; "
              + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
              + f" (repack alone ~{parts['upload + repack'] - parts['upload']:.3f}"
              " s)", flush=True)
        if not same or snp.snparray.words.device.type != dev.type:
            raise AssertionError("io: read_plink differs from the genotypes "
                                 "it was written from")
        t0 = time.perf_counter()
        hs = HostStreamedGenotypes.from_plink(prefix, device=dev)
        t_hs = time.perf_counter() - t0
        read = snp.snparray
        same = (np.array_equal(hs.words, read.words.cpu().numpy())
                and torch.equal(hs.mu, read.mu)
                and torch.equal(hs.inv_sd, read.inv_sd)
                and hs.has_missing == read.has_missing)
        print(f"[io] HostStreamedGenotypes.from_plink on {card}: {t_hs:.3f} "
              f"s (the .bed repacked a chunk at a time on the card, the words "
              f"brought to host memory); host words and mu / inv_sd equal to "
              f"read_plink's bit for bit {same}", flush=True)
        if not same:
            raise AssertionError("io: from_plink differs from read_plink")
        del hs, read

        out = {k: os.path.join(tmp, k) for k in
               ("summary", "beta", "cov", "cvsummary")}
        reset_launches()
        t0 = time.perf_counter()
        a = iht(prefix, K, Normal, summaryfile=out["summary"],
                betafile=out["beta"], verbose=False, device=dev)
        t_iht = time.perf_counter() - t0
        launches["iht"] = kernels.LAUNCHES["xt_dots_words_t"]
        b = fit_iht(y, g, np.ones(g.n), k=K, verbose=False)
        with open(out["beta"]) as f:
            rows = sum(1 for _ in f) - 1
        same = (np.array_equal(a.beta, b.beta) and np.array_equal(a.c, b.c)
                and a.logl == b.logl and a.iter == b.iter)
        print(f"[io] iht(prefix, {K}, Normal) on {card}: {t_iht:.3f} s, iter "
              f"{a.iter}, logl {a.logl}, kernel-2 launches {launches['iht']}; "
              f"beta, c, logl and iterations equal to fit_iht in memory bit "
              f"for bit {same}; beta file {rows} rows", flush=True)
        if not same or rows != P or launches["iht"] < a.iter + 1:
            raise AssertionError("io: iht differs from fit_iht")

        reset_launches()
        t0 = time.perf_counter()
        mse = cross_validate(prefix, Normal, path=CV_PATH, q=CV_Q,
                             cv_summaryfile=out["cvsummary"], verbose=False,
                             max_iter=CV_MAX_ITER,
                             rng=np.random.default_rng(SEED), device=dev)
        t_cv = time.perf_counter() - t0
        launches["cross_validate"] = kernels.LAUNCHES["xt_dots_words_t"]
        best = CV_PATH[int(np.argmin(mse))]
        same = np.array_equal(mse, dual_mse)
        print(f"[io] cross_validate(prefix, Normal, path 1:{CV_PATH[-1]}, "
              f"q={CV_Q}) on {card}: {t_cv:.3f} s, best k {best}, kernel-2 "
              f"launches {launches['cross_validate']}; mse equal to the cv "
              f"phase's bit for bit {same}", flush=True)
        if not same or best != K or launches["cross_validate"] < 2:
            raise AssertionError("io: cross_validate differs from cv_iht")

        reset_launches()
        t0 = time.perf_counter()
        a = iht(prefix2, MV_K, MvNormal, phenotypes=[6, 7, 8],
                summaryfile=out["summary"], betafile=out["beta"],
                covariancefile=out["cov"], verbose=False, device=dev)
        t_mv = time.perf_counter() - t0
        launches["mv iht"] = kernels.LAUNCHES["xt_dots_words_t"]
        b = fit_iht(Y, g, np.ones((1, g.n)), k=MV_K, d=MvNormal(),
                    verbose=False)
        sigma = np.loadtxt(out["cov"])
        same = (np.array_equal(a.beta, b.beta) and np.array_equal(a.c, b.c)
                and np.array_equal(a.Sigma, b.Sigma) and a.logl == b.logl
                and a.iter == b.iter)
        print(f"[io] iht(prefix2, {MV_K}, MvNormal, phenotypes=[6, 7, 8]) on "
              f"{card}: {t_mv:.3f} s, iter {a.iter}, logl {a.logl}, "
              f"kernel-2 launches {launches['mv iht']}; equal to fit_iht on "
              f"the same Y bit for bit {same}; covariance file "
              f"{sigma.shape}", flush=True)
        if (not same or sigma.shape != (MV_TRAITS, MV_TRAITS)
                or not np.allclose(sigma, a.Sigma, rtol=1e-7)):
            raise AssertionError("io: the multivariate iht differs")
        del snp

        # n % 4 == 3 and missing calls: the card's read equals the CPU's
        words, mu, inv_sd, hm, _, _ = simulate_packed_problem(
            np.random.default_rng(SEED + 5), IO_N, P_PARITY, missing=True)
        small = PackedGenotypes.from_numpy(words, mu, inv_sd, n=IO_N,
                                           p=P_PARITY, has_missing=hm,
                                           device=dev)
        prefix3 = os.path.join(tmp, "missing")
        write_trio(prefix3, small, np.zeros(IO_N))
        on_card = read_plink(prefix3, device=dev).snparray
        on_cpu = read_plink(prefix3, device="cpu").snparray
        same = (same_genotypes(on_card, on_cpu)
                and same_genotypes(on_card, small)
                and np.array_equal(on_card.n_missing, on_cpu.n_missing))
        print(f"[io] read_plink at {IO_N} x {P_PARITY} (n % 4 = {IO_N % 4}, "
              f"missing calls {on_cpu.has_missing}): the card's words and "
              f"stats equal to the CPU's and to the written genotypes' "
              f"{same}", flush=True)
        if not same or not on_cpu.has_missing:
            raise AssertionError("io: the card's read differs from the CPU's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[io] phase in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def write_vcf(path, codes):
    """A GT VCF of (n, p) PLINK codes (01 missing as ./.)."""
    gt = np.array(["0/0", "./.", "0/1", "1/1"])
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(codes.shape[0])) + "\n")
        for j in range(codes.shape[1]):
            f.write(f"1\t{100 * (j + 1)}\tsnp{j + 1}\t1\t2\t.\tPASS\t.\tGT\t"
                    + "\t".join(gt[codes[:, j]]) + "\n")


def dense_columns(g, cols, chunk=4096):
    """The (n, len(cols)) f32 standardized columns ``cols`` of g, made on
    g's device by ``PackedOp.gather_cols`` a chunk at a time."""
    op = PackedOp(g)
    X = torch.empty((g.n, len(cols)), dtype=torch.float32, device=g.device)
    for lo in range(0, len(cols), chunk):
        idx = torch.as_tensor(cols[lo:lo + chunk], device=g.device)[None]
        Z = op.gather_cols(idx, torch.ones(idx.shape, device=g.device))
        X[:, lo:lo + idx.shape[1]] = Z[0, :, :g.n].T
    return X


def phase_dense(g, causal, y, card, dev):
    """The dense design (``DenseOp``): at N_PARITY x P_PARITY a VCF of the
    parity genotypes, ``parse_genotypes`` against the PLINK trio's
    standardized matrix (1e-12), ``iht`` of it on the card and on the CPU
    (same support, iterations within one) and against the PLINK ``iht`` on
    the card (same support), TF32 switched on leaving DenseOp's products
    unchanged, ``grm`` on the card within 1e-4 of the CPU's float64 loop;
    then at N x DENSE_P the standardized columns of g (every causal SNP
    among them), ``fit_iht`` and ``cv_iht`` on them, cold then warm, no
    score kernel launched, every causal SNP found (as phase_fit holds the
    packed fit to all K), and a ``profiling.trace`` of a warm fit and cv."""
    t_phase = time.perf_counter()
    n, p = N_PARITY, P_PARITY
    words, mu, inv_sd, hm, pc, pb = simulate_packed_problem(
        np.random.default_rng(3), n, p, k=K, missing=True)
    cpu_g = PackedGenotypes.from_numpy(words, mu, inv_sd, n=n, p=p,
                                       has_missing=hm, device="cpu")
    yp = phenotype(cpu_g, pc, pb, 4)
    tmp = tempfile.mkdtemp(prefix="mendeliht_dense_")
    try:
        vcf, prefix, phen = (os.path.join(tmp, s) for s in
                             ("parity.vcf", "parity", "parity.phen"))
        t0 = time.perf_counter()
        write_vcf(vcf, cpu_g.to_codes())
        write_trio(prefix, cpu_g, yp)
        np.savetxt(phen, yp, fmt="%.17g")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        X = parse_genotypes(vcf, device=dev)[0]
        t_parse = time.perf_counter() - t0
        ref = read_plink(prefix, dtype=torch.float64, device="cpu")
        err = float(np.abs(X - ref.snparray.to_dense_standardized()).max())
        print(f"[dense] VCF (GT) of the {n} x {p} parity genotypes written "
              f"with its PLINK trio in {t_write:.2f} s, parse_genotypes "
              f"{t_parse:.2f} s; max |VCF - PLINK standardized| {err:.3g}",
              flush=True)
        if not err <= 1e-12:
            raise AssertionError("dense: the VCF and PLINK matrices differ")
        del X, ref
        kw = dict(phenotypes=phen, summaryfile=os.path.join(tmp, "s"),
                  betafile=os.path.join(tmp, "b"), verbose=False)
        reset_launches()
        fits = {}
        for label, target, device in (("vcf card", vcf, dev),
                                      ("vcf cpu", vcf, "cpu"),
                                      ("plink card", prefix, dev)):
            t0 = time.perf_counter()
            r = iht(target, K, Normal, device=device, **kw)
            fits[label] = (set(np.flatnonzero(r.beta).tolist()), r.iter,
                           time.perf_counter() - t0)
            if label == "vcf cpu":
                dense_launches = sum(kernels.LAUNCHES.values())
        (sa, ia, ta), (sb, ib, tb), (sc, ic, tc) = fits.values()
        print(f"[dense] iht of the VCF on {card}: iter {ia}, {ta:.3f} s; on "
              f"the CPU: iter {ib}, {tb:.3f} s; same support {sa == sb}; the "
              f"PLINK trio's iht on the card: iter {ic}, same support "
              f"{sa == sc}; score-kernel launches of the dense fits "
              f"{dense_launches}", flush=True)
        if sa != sb or abs(ia - ib) > 1 or sa != sc or dense_launches:
            raise AssertionError("dense: the VCF fits disagree")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    card_g = PackedGenotypes.from_numpy(words, mu, inv_sd, n=n, p=p,
                                        has_missing=hm, device=dev)
    t0 = time.perf_counter()
    G = grm(card_g)
    t_grm = time.perf_counter() - t0
    t0 = time.perf_counter()
    G64 = grm(cpu_g)
    t_grm64 = time.perf_counter() - t0
    err = float(np.abs(G - G64).max() / np.abs(G64).max())
    print(f"[dense] grm {n} x {p} on {card}: {t_grm:.3f} s; the CPU's "
          f"float64 loop {t_grm64:.3f} s; max rel err {err:.3g}", flush=True)
    if not err <= 1e-4:
        raise AssertionError("dense: grm on the card differs from the CPU's")
    del card_g, cpu_g, G, G64

    cols = np.sort(np.concatenate(
        [causal, np.setdiff1d(np.arange(DENSE_P), causal)[:DENSE_P - K]]))
    t0 = time.perf_counter()
    X = dense_columns(g, cols)
    sync_on(dev)
    print(f"[dense] {N} x {DENSE_P} f32 standardized columns of the "
          f"flagship genotypes ({X.numel() * 4 / 1e9:.2f} GB, every causal "
          f"SNP among them) by gather_cols in {time.perf_counter() - t0:.2f} "
          "s", flush=True)
    op = DenseOp(X)
    R = torch.randn((CV_Q * len(CV_PATH), N), device=dev)
    try:
        torch.set_float32_matmul_precision("high")
        on = op.xtr(R)
    finally:
        torch.set_float32_matmul_precision("highest")
    same = torch.equal(on, op.xtr(R))
    print(f"[dense] DenseOp.xtr at m = {R.shape[0]} with TF32 switched on "
          f"equal to it with TF32 off bit for bit {same}", flush=True)
    if not same:
        raise AssertionError("dense: TF32 changed DenseOp's products")
    del R, on
    causal_set = set(causal.tolist())
    torch.cuda.reset_peak_memory_stats()
    walls, res = [], None
    for run in range(1 + DENSE_WARM):
        reset_launches()
        t0 = time.perf_counter()
        r = fit_iht(y, X, k=K, verbose=False)
        walls.append(time.perf_counter() - t0)
        sel = cols[np.flatnonzero(r.beta)]
        got = (set(sel.tolist()), r.iter, r.logl)
        if (len(sel) != K or sum(kernels.LAUNCHES.values())
                or run and got != res):
            raise AssertionError("dense: the fit failed its checks")
        res = got
    found = len(res[0] & causal_set)
    print(f"[dense] fit_iht {N} x {DENSE_P} k={K} on {card}: cold "
          f"{walls[0]:.4f} s, {DENSE_WARM} warm median "
          f"{np.median(walls[1:]):.4f} s (range {min(walls[1:]):.4f}-"
          f"{max(walls[1:]):.4f}); iter {res[1]}, logl {res[2]}, causal "
          f"recovered {found}/{K} (the packed fit's {K}/{K}), "
          "no score-kernel launch", flush=True)
    walls, first = [], None
    for run in range(1 + DENSE_WARM):
        reset_launches()
        t0 = time.perf_counter()
        mse = cv_iht(y, X, path=CV_PATH, q=CV_Q, verbose=False,
                     max_iter=CV_MAX_ITER, rng=np.random.default_rng(SEED))
        walls.append(time.perf_counter() - t0)
        if (not np.all(np.isfinite(mse)) or sum(kernels.LAUNCHES.values())
                or run and not np.array_equal(mse, first)):
            raise AssertionError("dense: the cv failed its checks")
        first = mse
    best = CV_PATH[int(np.argmin(mse))]
    peak = torch.cuda.max_memory_allocated()
    print(f"[dense] cv_iht {N} x {DENSE_P} path 1:{CV_PATH[-1]} q={CV_Q} on "
          f"{card}: cold {walls[0]:.4f} s, {DENSE_WARM} warm median "
          f"{np.median(walls[1:]):.4f} s (range {min(walls[1:]):.4f}-"
          f"{max(walls[1:]):.4f}); best k {best}; peak device memory of the "
          f"fits and cvs {peak / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)", flush=True)
    if found < K or best != K:
        raise AssertionError(f"dense: causal recovery {found}, best k {best}")
    for what, call in (
            ("fit", lambda: fit_iht(y, X, k=K, verbose=False)),
            ("cv", lambda: cv_iht(y, X, path=CV_PATH, q=CV_Q, verbose=False,
                                  max_iter=CV_MAX_ITER,
                                  rng=np.random.default_rng(SEED)))):
        with profiling.trace() as s:
            call()
        print(f"[dense] traced warm {what} on {card}: {trace_text(s)}",
              flush=True)
        for name, ms, count in s["kernels"][:6]:
            print(f"[dense]   {ms:9.3f} ms {count:6d}x  {name[:110]}",
                  flush=True)
        if not s["device_busy_ms"] > 0:
            raise AssertionError(f"dense: the {what} trace shows no device "
                                 "time")
    print(f"[dense] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def phase_lab(g, card):
    """The kernel lab's entry points on the 10k x 1M genotypes, then its
    sweep of kernels 1, 2 and 6 and kernels 4 and 5 against their plain
    versions; returns per-kernel stats for the kernels line."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    res = lab.main(["--quick"], g=g, device=g.device)
    res.update(lab.main(["--attrib"], g=g, device=g.device))
    launches = dict(kernels.LAUNCHES)
    print(f"[lab] launches in the lab run: {launches}", flush=True)
    if min(launches[k] for k in LAB_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched by the lab: "
                             f"{launches}")
    if res["int4_probe"] != PROBE_VERDICTS:
        raise AssertionError(f"probe verdicts {res['int4_probe']} differ "
                             f"from the reference's {PROBE_VERDICTS}")
    ing = res["int4_ingestion"]
    print(f"[lab] probe verdicts as the reference's; ingestion i8 "
          f"{ing['i8_us']:.3f} us, i4 {ing['i4_us']:.3f} us per carried "
          f"call on {card}; attrib {res['attrib_m100']}", flush=True)

    def quad(a, r):
        return kernels.xt_dots_words(a, r, want_missing=False)[0]

    def vt(a, r):
        return kernels.xt_dots_words_t(a, r, want_missing=False, p=g.p)[0]

    iters = lambda m: 25 if m <= 8 else 5                       # noqa: E731
    sweeps = {"kernel 1": lab.sweep("kernel 1 quad", quad, g.words, g.n_pad,
                                    iters=iters),
              "kernel 2": lab.sweep("kernel 2 vt int8", vt, g.words_t,
                                    g.n_pad, iters=iters),
              "kernel 6": lab.sweep("kernel 6 vt int8", kernels.xt_dots_T,
                                    g.words_t, g.n_pad, iters=iters)}
    print(f"[lab] sweep on {card}, ms per pass, {g.n} x {g.p}:", flush=True)
    print("[lab]     m " + "".join(f"{k:>10}" for k in sweeps), flush=True)
    for m in lab.WIDTHS:
        row = "".join(f"{t[m]:10.3f}" for t in sweeps.values())
        fastest = min(sweeps, key=lambda k: sweeps[k][m])
        print(f"[lab] {m:5d} {row}   fastest {fastest}", flush=True)
    return dict(unpack=lab_unpack(g.device), dot=lab_dot(g.device),
                launches=launches)


def launch_floor(kern, match, out, reps=200):
    """Device ms per call of ``kern`` (its kernels named ``match``) and of
    ``out.zero_()``, one launch that only writes ``kern``'s output: the
    least a launch that writes those bytes takes on this card.  Timed in
    turns (zero, kernel, kernel, zero); returns (kernel ms, floor ms)."""
    zero = out.zero_
    floor = [device_ms(zero, reps)]
    ms = [device_ms(kern, reps, match), device_ms(kern, reps, match)]
    floor.append(device_ms(zero, reps))
    return sum(ms) / 2, sum(floor) / 2


def lab_unpack(dev):
    """Kernel 4 at the probe's shapes: the unpack (32, 256) and the
    packed-rhs probe dot (8, 256) x (256, 512) (``rhs_dot_kernel``, its
    unguarded instantiation for this shape and the guarded one) equal to
    plain, each timed in turns with its one-launch floor, a zero fill of
    its output."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=(32, 256))
                         .astype(np.int32)).to(dev)
    for bits in (4, 8):
        if not torch.equal(kernels.unpack_words(x, bits),
                           decode.unpack_words(x, bits)):
            raise AssertionError(f"unpack_words({bits}) differs from plain")
    ms, floor = launch_floor(lambda: kernels.unpack_words(x, 4),
                             "unpack_kernel", kernels.unpack_words(x, 4))
    plain_ms = device_ms(lambda: decode.unpack_words(x, 4), 200)
    # the lab's dot_i8_lhs_i4_rhs: (8, 256) int8 . int4 fields of (32, 512)
    w = torch.from_numpy(rng.integers(-2**31, 2**31, size=(32, 512))
                         .astype(np.int32)).to(dev)
    a = torch.from_numpy(rng.integers(-128, 128, size=(8, 256))
                         .astype(np.int8)).to(dev)
    dot = lambda: kernels.int_dot_packed(w, a, 4, lhs_packed=False)  # noqa
    gen = lambda: kernels.int_dot_packed(w, a, 4, False, general=True)  # noqa
    want = decode.int_dot_packed(w, a, 4, False)
    if not (torch.equal(dot(), want) and torch.equal(gen(), want)):
        raise AssertionError("the packed-rhs probe dot differs from plain")
    # its two instantiations in turns with the floor (fill, unguarded,
    # guarded, guarded, unguarded, fill): the unguarded one is kept only
    # for its time at this shape
    out = dot()
    floors = [device_ms(out.zero_, 200)]
    exact = [device_ms(dot, 200, "rhs_dot_kernel")]
    guarded = [device_ms(gen, 200, "rhs_dot_kernel"),
               device_ms(gen, 200, "rhs_dot_kernel")]
    exact.append(device_ms(dot, 200, "rhs_dot_kernel"))
    floors.append(device_ms(out.zero_, 200))
    dot_ms, gen_ms, dot_floor = (sum(v) / 2 for v in (exact, guarded, floors))
    spread = max(abs(exact[0] - exact[1]), abs(guarded[0] - guarded[1]))
    if dot_ms > gen_ms:
        raise AssertionError(f"the unguarded rhs_dot_kernel ({dot_ms:.6f} "
                             f"ms) is slower than the guarded one "
                             f"({gen_ms:.6f} ms) at the shape it is for")
    dot_plain = device_ms(lambda: decode.int_dot_packed(w, a, 4, False), 20)
    dot_bound = bound(dev, w.numel() * 4 + a.numel() + 8 * 512 * 4,
                      2 * 8 * 256 * 512, "int8")
    b = bound(dev, 32 * 256 * 4 * 9, 0, "f32")
    print(f"[lab] unpack_words (32, 256) int4 and int8: equal to plain; "
          f"kernel {ms * 1e3:.3f} us, a zero fill of its (256, 256) int32 "
          f"output {floor * 1e3:.3f} us ({ms / floor:.2f}x the one-launch "
          f"floor), bytes bound {b['bound_ms'] * 1e3:.3f} us, plain "
          f"{plain_ms * 1e3:.3f} us of device time per call (profiler)",
          flush=True)
    print(f"[lab] rhs_dot_kernel (8, 256) x int4 (256, 512): both "
          f"instantiations equal to plain (random operands); unguarded "
          f"{dot_ms * 1e3:.3f} us, a zero fill of its (8, 512) int32 output "
          f"{dot_floor * 1e3:.3f} us ({dot_ms / dot_floor:.3f}x the "
          f"one-launch floor); guarded {gen_ms * 1e3:.3f} us "
          f"({gen_ms / dot_floor:.3f}x), {(gen_ms - dot_ms) * 1e3:.3f} us "
          f"slower against a spread of {spread * 1e3:.3f} us between turns; "
          f"bound {dot_bound['bound_ms'] * 1e3:.3f} us "
          f"({dot_bound['bound_by']}), plain {dot_plain * 1e3:.3f} us of "
          f"device time per call", flush=True)
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, shape=[32, 256],
                **b, floor_ms=floor, library_ms=None, rhs_dot_ms=dot_ms,
                rhs_dot_floor_ms=dot_floor, rhs_dot_guarded_ms=gen_ms,
                rhs_dot_spread_ms=spread,
                rhs_dot_bound_ms=dot_bound["bound_ms"],
                rhs_dot_plain_ms=dot_plain)


def cold_ms(fn, reps, match, dev):
    """:func:`device_ms` of ``fn``'s kernels (those whose name holds
    ``match``, or all of them) with the L2 emptied before each call by a
    read of FLUSH_BYTES: clean lines, so the call's own misses write nothing
    back.  The flush's own kernels are left out by name."""
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    with profiling.trace(top=64) as s:
        flush.sum()
    skip = {name for name, _, _ in s["kernels"]}

    def call():
        flush.sum()
        fn()

    return device_ms(call, reps, match, skip)


def lab_dot(dev):
    """Kernel 4's probe dots and kernel 5's ingestion dot equal to plain
    (the lab's all-ones operands and random full-range ones); kernel 5 timed
    alone at the lab's shape, cold (L2 emptied between calls) and warm (the
    lab's loop on one operand), beside its plain version, its bound and
    ``torch._int_mm`` on the unpacked int8 operand, timed the same two ways."""
    probes = (((32, 256), (256, 128), 4, True),
              ((32, 512), (8, 256), 4, False))
    for xs, ys, bits, lhs in probes:
        x = torch.arange(int(np.prod(xs)), dtype=torch.int32,
                         device=dev).reshape(xs) % 3
        y = torch.arange(int(np.prod(ys)), dtype=torch.int32,
                         device=dev).reshape(ys) % 3
        if not torch.equal(kernels.int_dot_packed(x, y, bits, lhs),
                           decode.int_dot_packed(x, y, bits, lhs)):
            raise AssertionError(f"probe dot {xs} x {ys} differs from plain")
    M, K, N = lab.INGEST_SHAPE
    rng = np.random.default_rng(SEED)
    out = {}
    for bits in (8, 4):
        x, y = lab.ingestion_operands(bits, dev)
        got = kernels.int_dot_packed(x, y, bits)
        if not (torch.equal(got, decode.int_dot_packed(x, y, bits))
                and int(got[::32 // bits].min()) == K
                and int(got.sum()) == K * N * M * bits // 32):
            raise AssertionError(f"ingestion dot ({bits} bits) is wrong")
        xr = torch.from_numpy(rng.integers(-2**31, 2**31, size=x.shape)
                              .astype(np.int32)).to(dev)
        yr = torch.from_numpy(rng.integers(-128, 128, size=y.shape)
                              .astype(np.int8)).to(dev)
        if not torch.equal(kernels.int_dot_packed(xr, yr, bits),
                           decode.int_dot_packed(xr, yr, bits)):
            raise AssertionError(f"ingestion dot ({bits} bits) on random "
                                 "operands differs from plain")
        kern = lambda: kernels.int_dot_packed(x, y, bits)       # noqa: E731
        cold = cold_ms(kern, 50, "ingest_dot_kernel", dev)
        warm = device_ms(kern, lab.INGEST_REPS, "ingest_dot_kernel")
        call = device_ms(kern, lab.INGEST_REPS)     # with y's staging copy
        plain_ms = device_ms(lambda: decode.int_dot_packed(x, y, bits), 20)
        # the yardstick of one cold read of the same bytes: kernel 3
        c0 = torch.zeros(1, dtype=torch.int32, device=dev)
        read = cold_ms(lambda: kernels.read_words(x, c0), 50,
                       "read_words_kernel", dev)
        b = bound(dev, x.numel() * 4 + K * N + 4 * M * N, 2 * M * K * N,
                  "int8")
        out[bits] = dict(ms=cold, ms_warm=warm, call_ms_warm=call,
                         plain_ms=plain_ms, share=b["bound_ms"] / cold,
                         read_ms=read, **b)
        print(f"[lab] ingestion dot ({M}, {K}) x ({K}, {N}), big operand "
              f"int{bits} ({x.numel() * 4 / 1e6:.1f} MB): equal to plain "
              f"(all-ones and random operands); kernel cold "
              f"{cold * 1e3:.3f} us ({b['bound_ms'] / cold:.3f} of the "
              f"bound), warm {warm * 1e3:.3f} us ({call * 1e3:.3f} us with "
              f"the wrapper's staging of y), plain "
              f"{plain_ms * 1e3:.3f} us of device time per call (profiler), "
              f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}); the "
              f"read probe (kernel 3) on the same words cold "
              f"{read * 1e3:.3f} us", flush=True)
    x8, y8 = lab.ingestion_operands(8, dev)
    a8 = decode.unpack_words(x8, 8).to(torch.int8)          # (M, K) int8
    if not torch.equal(torch._int_mm(a8, y8),
                       kernels.int_dot_packed(x8, y8, 8)):
        raise AssertionError("torch._int_mm differs from the kernel")
    lib = lambda: torch._int_mm(a8, y8)                         # noqa: E731
    library_ms = cold_ms(lib, 50, None, dev)
    library_warm = device_ms(lib, lab.INGEST_REPS)
    print(f"[lab] torch._int_mm on the unpacked int8 operand: cold "
          f"{library_ms * 1e3:.3f} us, warm {library_warm * 1e3:.3f} us of "
          "device time per call", flush=True)
    i8, i4 = out[8], out[4]
    # the bytes decide: half of them, less time; and ahead of the library
    if not (i4["ms"] < i8["ms"] and i8["ms"] < library_ms
            and i8["ms_warm"] < library_warm):
        raise AssertionError(f"ingestion dot cold int4 {i4['ms']}, int8 "
                             f"{i8['ms']} ms (warm {i8['ms_warm']}) against "
                             f"torch._int_mm {library_ms} ({library_warm})")
    return dict(i8, max_abs_err=0.0, shape=[M, K, N], library_ms=library_ms,
                library_ms_warm=library_warm,
                **{f"{k}_i4": v for k, v in i4.items()})


def check_rounds(small, gen):
    """Kernel 7 equal to its plain version on the round-3 words of each of
    the genotypes ``small`` at each of the probe's widths."""
    for s in small:
        w3 = probe.round3_words(s)
        for m in PROBE_WIDTHS:
            rhs = rhs_on(s, m, gen)
            got = kernels.xt_i8_rounds(w3, rhs)
            ref = decode.xt_i8_rounds(w3, rhs)
            sync()
            if not torch.equal(got, ref):
                raise AssertionError(f"kernel 7 differs from plain at {s.n} x "
                                     f"{s.p}, m={m}: {rel_err(got, ref)}")
            print(f"[kprobe] n={s.n} p={s.p} m={m} missing={s.has_missing}: "
                  "kernel 7 bit-equal to plain", flush=True)


def probe_rounds(g, w3, gen):
    """Kernel 7 at 10k x 1M: equal to plain and to kernels 6 and 2's A on
    the transposed words, at the default tp and the probe's other two (a
    no-op), then timed beside plain and its bound; per-width stats."""
    out = {}
    for m in PROBE_WIDTHS:
        rhs = rhs_on(g, m, gen)
        got = kernels.xt_i8_rounds(w3, rhs)
        ref = decode.xt_i8_rounds(w3, rhs)
        sync()
        same = torch.equal(got, ref)
        abs_err = float((got - ref).abs().max())
        del ref
        same6 = torch.equal(got, kernels.xt_dots_T(g.words_t, rhs))
        same2 = torch.equal(got, kernels.xt_dots_words_t(
            g.words_t, rhs, want_missing=False, p=g.p)[0])
        same_tp = {tp: torch.equal(kernels.xt_i8_rounds(w3, rhs, tp=tp), got)
                   for tp in PROBE_TPS}
        del got
        if not (same and same6 and same2 and all(same_tp.values())):
            raise AssertionError(f"kernel 7 at {g.n} x {g.p}, m={m}: equal "
                                 f"to plain {same}, to kernel 6 {same6}, to "
                                 f"kernel 2's A {same2}, at other tp "
                                 f"{same_tp}")
        ms, plain_ms, runs = interleaved(
            lambda: kernels.xt_i8_rounds(w3, rhs),
            lambda: decode.xt_i8_rounds(w3, rhs),
            reps=20 if m == 1 else 10, plain_reps=PLAIN_REPS)
        b = score_bound(g, m, "int8", planes=3)
        out[m] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=abs_err, **b)
        print(f"[kprobe] kernel 7 {g.n} x {g.p} m={m}: bit-equal to plain "
              f"(tp = {kernels.TP}, {PROBE_TPS[0]}, {PROBE_TPS[1]}) and "
              f"to kernels 6 and 2's A; kernel {ms:.3f} ms (runs "
              f"{runs[0]:.3f}, {runs[1]:.3f}), plain {plain_ms:.3f} ms (runs "
              f"{runs[2]:.3f}, {runs[3]:.3f}), bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}), {b['bound_ms'] / ms:.3f} of it per X'R "
              "pass", flush=True)
    return out


def probe_xor(g):
    """Kernels 8 and 9 on the quad words at the probe's tp (a ragged last
    tile): equal to plain with a seed of 0 and one that wraps, then timed in
    turns (8, 9, 9, 8: the same reads, one with the decode); kernel 9 also
    with a word-column tile that leaves a ragged column."""
    words, tp = g.words, kernels.TP
    p4, nw = words.shape
    calls = {"stream_xor": (lambda s: kernels.stream_xor(words, s, tp),
                            lambda s: decode.stream_xor(words, s, tp)),
             "decode_only": (lambda s: kernels.decode_only(words, s, tp),
                             lambda s: decode.decode_only(words, s, tp, nw))}
    st = torch.tensor([[WRAP_SEED]], dtype=torch.int32, device=g.device)
    plain_ms = {}
    for name, (kern, plain) in calls.items():
        for seed in (0, WRAP_SEED):
            s = torch.tensor([[seed]], dtype=torch.int32, device=g.device)
            if not torch.equal(kern(s), plain(s)):
                raise AssertionError(f"{name} differs from plain, seed {seed}")
        plain_ms[name] = cuda_ms(lambda: plain(st), 2)
    runs = {name: [] for name in calls}
    for name in ("stream_xor", "decode_only", "decode_only", "stream_xor"):
        runs[name].append(cuda_ms(lambda: calls[name][0](st), 20))
    out = {}
    for name, r in runs.items():
        ms = sum(r) / len(r)
        b = bound(g.device, words.numel() * 4 + tp * nw * 4,
                  XOR_OPS[name] * words.numel(), "int32")
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms[name], **b,
                         share=b["bound_ms"] / ms, library_ms=None, tp=tp)
        print(f"[kprobe] {name} ({p4}, {nw}) tp={tp} (last tile {p4 % tp} "
              f"rows): equal to plain for seeds 0 and {WRAP_SEED}; kernel "
              f"{ms:.3f} ms (runs {r[0]:.3f}, {r[1]:.3f}), "
              f"{words.numel() * 4 / ms / 1e6:.1f} GB/s; plain "
              f"{plain_ms[name]:.3f} ms; bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}), {b['bound_ms'] / ms:.3f} of it", flush=True)
    ratio = out["decode_only"]["ms"] / out["stream_xor"]["ms"]
    print(f"[kprobe] decode_only / stream_xor in turns: {ratio:.3f}",
          flush=True)
    if not ratio <= DECODE_SLACK:
        raise AssertionError(f"decode_only takes {ratio:.3f} x stream_xor's "
                             f"time on the same reads (at most "
                             f"{DECODE_SLACK})")
    tw = 1000
    if not torch.equal(kernels.decode_only(words, st, tp, tw),
                       decode.decode_only(words, st, tp, tw)):
        raise AssertionError(f"decode_only differs from plain at tw={tw}")
    print(f"[kprobe] decode_only tw={tw} (last column tile {nw % tw}): equal "
          "to plain", flush=True)
    return out


def phase_kprobe(g, card, gen):
    """The round-3 kernel probe's kernels against their plain versions at
    10k x 1M, then its entry point with the launches counted; returns
    per-kernel stats for the kernels line."""
    w3 = probe.round3_words(g)
    if not torch.equal(w3, g.words_t.t()):
        raise AssertionError("round3_words differs from words_t.T")
    print(f"[kprobe] round3_words {g.n} x {g.p}: {tuple(w3.shape)}, equal to "
          "words_t.T", flush=True)
    rounds = probe_rounds(g, w3, gen)
    del w3
    xor = probe_xor(g)
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    res = probe.main([str(m) for m in PROBE_WIDTHS], g=g, device=g.device)
    launches = dict(kernels.LAUNCHES)
    print(f"[kprobe] launches in the probe run on {card}: {launches}",
          flush=True)
    if min(launches[k] for k in PROBE_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched by the probe: "
                             f"{launches}")
    failed = {(m, v): t for m, vs in res["variants"].items()
              for v, t in vs.items() if isinstance(t, str)}
    if failed or res["i8_rounds_rel_err"] != 0.0:
        raise AssertionError(f"the probe failed: {failed}, kernel 7 vs "
                             f"kernel 1 {res['i8_rounds_rel_err']}")
    top = rounds[PROBE_WIDTHS[-1]]
    k7 = dict(top, m=PROBE_WIDTHS[-1], library_ms=None,
              max_abs_err=max(r["max_abs_err"] for r in rounds.values()))
    for m in PROBE_WIDTHS[:-1]:
        k7.update({f"ms_m{m}": rounds[m]["ms"],
                   f"plain_ms_m{m}": rounds[m]["plain_ms"],
                   f"bound_ms_m{m}": rounds[m]["bound_ms"]})
    return dict(xt_i8_rounds=k7, **xor), launches


def phase_missing(g, y, card, gen):
    """Kernels 2 and 1 with their missing plane at the cv width, each bit
    for bit against plain and equal to each other, then the cv, on 10k x 1M
    genotypes with missing calls; returns each kernel's (ms, plain ms, rel
    err, abs err, bound ms) at m = 100, under "moments" their fields at
    the widths of ``moment_widths`` with the missing plane, and under
    "mse" the cv's."""
    g.with_dual_layout()
    bound_of = int8_bound_of(g, missing=True)
    out = {}
    for name, kern, plain, arr in (
            ("xt_dots_words_t", kernels.xt_dots_words_t,
             decode.xt_dots_words_t, g.words_t),
            ("xt_dots_words", kernels.xt_dots_words, decode.xt_dots_words,
             g.words)):
        times = time_widths(f"cv-miss {name}", kern, plain, arr, g, gen,
                            widths=(100,), bound_of=bound_of)
        out[name] = (*times[100], bound_of(100)["bound_ms"])
    check_layouts("cv-miss", g, 100, gen)
    out["moments"] = moment_widths("cv-miss", g, gen)
    _, out["mse"] = phase_cv("cv-miss", g, y, card, warm=1)
    phase_profile(g, y, card,
                  calls=(("cv-miss", "xt_dots_t", lambda: run_cv(g, y)),))
    return out


def phase_budget(dev, card):
    """Past the dual-layout budget: 51,200 x 1,000,000 random quad words
    made on the card (12.8 GB; every byte value, so every crumb code),
    their transposed words, and kernels 1 and 2 at m = 1 and 100 with the
    missing plane, equal bit for bit, timed in turns (kernel 2, kernel 1,
    kernel 1, kernel 2) beside their bound; returns per-kernel fields for
    the kernels line."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p4, n4 = P // 4, N_BIG // 4
    words = torch.randint(0, 256, (p4, 4 * n4), dtype=torch.uint8,
                          device=dev, generator=gen).view(torch.int32)
    sync()
    t0 = time.perf_counter()
    words_t = kernels.build_words_t(words, P)
    sync()
    relayout = time.perf_counter() - t0
    # the fields of genotypes that the checks and bounds read
    g = types.SimpleNamespace(words=words, words_t=words_t, n=N_BIG,
                              n_pad=N_BIG, p=P, device=dev, has_missing=True)
    print(f"[budget] {N_BIG} x {P}: {words.numel() * 4 / 1e9:.1f} GB of quad "
          f"words made on the card; build_words_t {relayout * 1e3:.1f} ms on "
          f"{card}", flush=True)
    out = {"xt_dots_words": {}, "xt_dots_words_t": {}}
    for m in (1, 100):
        check_layouts("budget", g, m, gen)
        rhs = rhs_on(g, m, gen)
        kw = dict(want_missing=True, p=P)
        reps = 10 if m == 1 else 3
        k1 = lambda: kernels.xt_dots_words(words, rhs, **kw)      # noqa: E731
        k2 = lambda: kernels.xt_dots_words_t(words_t, rhs, **kw)  # noqa: E731
        runs2 = [cuda_ms(k2, reps)]
        runs1 = [cuda_ms(k1, reps), cuda_ms(k1, reps)]
        runs2.append(cuda_ms(k2, reps))
        b = int8_bound_of(g, missing=True)(m)
        key = f"n{N_BIG}_m{m}_missing"
        for name, runs in (("xt_dots_words", runs1),
                           ("xt_dots_words_t", runs2)):
            ms = sum(runs) / 2
            out[name].update({f"ms_{key}": ms, f"bound_ms_{key}": b["bound_ms"]})
            print(f"[budget] {name} {N_BIG} x {P} m={m} missing=True: "
                  f"{ms:.3f} ms (runs {runs[0]:.3f}, {runs[1]:.3f}), bound "
                  f"{b['bound_ms']:.3f} ms ({b['bound_by']}), "
                  f"{b['bound_ms'] / ms:.3f} of it", flush=True)
    return out


def wall_ms(fn, reps):
    """Host ms per call of ``fn`` over ``reps`` calls after one, each run
    synchronised: for the streamed passes, whose copies run on a side
    stream."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_hostlink(dev, card):
    """The host-to-device rate of one HOSTLINK_BYTES block, pageable and
    page-locked in place (``cudaHostRegister``, as the streamed operator
    registers its host words), timed in turns (pageable, registered,
    registered, pageable); returns the registered rate in bytes/s."""
    host = np.ones(HOSTLINK_BYTES // 4, np.int32)        # pages touched
    src = torch.from_numpy(host)
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    copy = lambda: dst.copy_(src, non_blocking=True)    # noqa: E731
    cudart = torch.cuda.cudart()
    rates = {"pageable": [], "registered": []}
    for kind in ("pageable", "registered", "registered", "pageable"):
        if kind == "registered":
            err = int(cudart.cudaHostRegister(host.ctypes.data, host.nbytes,
                                              0))
            if err:
                raise RuntimeError(f"cudaHostRegister failed: {err}")
        try:
            rates[kind].append(HOSTLINK_BYTES / wall_ms(copy, 3) * 1e3)
        finally:
            if kind == "registered":
                cudart.cudaHostUnregister(host.ctypes.data)
    pageable, pinned = (sum(rates[k]) / 2 for k in ("pageable", "registered"))
    print(f"[hostlink] host-to-device copy of {HOSTLINK_BYTES >> 20} MiB on "
          f"{card}: pageable {pageable / 1e9:.2f} GB/s (runs "
          f"{', '.join(f'{r / 1e9:.2f}' for r in rates['pageable'])}), "
          f"registered in place {pinned / 1e9:.2f} GB/s (runs "
          f"{', '.join(f'{r / 1e9:.2f}' for r in rates['registered'])}); "
          f"data sheet PCIe Gen5 x16 {PCIE_BYTES_PER_S / 1e9:.0f} GB/s",
          flush=True)
    if not pinned > 0 or not pageable > 0:
        raise AssertionError("hostlink: no rate measured")
    return pinned


def stream_of(g, **kw):
    """HostStreamedGenotypes of g's words (copied to host memory) and their
    StreamedPackedOp, the registration and the prefix upload timed."""
    t0 = time.perf_counter()
    s = HostStreamedGenotypes.from_snparray(g, **kw)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    sop = StreamedPackedOp(s)
    sync()
    t_op = time.perf_counter() - t0
    return s, sop, t_host, t_op


class PlainQuadOp(PackedOp):
    """A PackedOp whose score is kernel 1's plain version on the card
    (``decode.xt_dots_words``): the reference the streamed passes are held
    to, beside kernel 1 on the resident words."""

    def _xt_dots(self, RT, want_sq=False):
        g = self.geno
        return decode.xt_dots_words(g.words, RT, want_missing=g.has_missing,
                                    want_sq=want_sq, p=g.p)


def streamed_bytes(sop):
    return sum(-(-hi // 4) - lo // 4 for lo, hi in sop._blocks()) \
        * sop.geno.words.shape[1] * 4


def check_stream_passes(name, sop, quad, gen, link, card, widths=(1, 100)):
    """The streamed ``xtr`` at each width and ``col_moments`` (m = 2, with
    S) against kernel 1 on the resident words (``quad``) and against its
    plain version (``decode.xt_dots_words``) on the same R, torch.equal;
    the pass time against the link bound (the streamed bytes over the
    measured registered rate, and over the data sheet's); returns {field:
    value}, ``launches`` the kernel-1 launches counted in one pass."""
    g = quad.geno
    plain = PlainQuadOp(g)
    out = {}
    per_pass = len(sop._blocks()) + (sop.prefix is not None)
    link_ms = streamed_bytes(sop) / link * 1e3
    sheet_ms = streamed_bytes(sop) / PCIE_BYTES_PER_S * 1e3
    for m in widths:
        R = rhs_on(g, m, gen).T.contiguous()
        reset_launches()
        got = sop.xtr(R)
        launches = kernels.LAUNCHES["xt_dots_words"]
        want = quad.xtr(R)
        ref = plain.xtr(R)
        sync()
        if not (torch.equal(got, want) and torch.equal(got, ref)) \
                or launches != per_pass:
            raise AssertionError(f"{name}: the streamed pass at m = {m} "
                                 f"differs from kernel 1 or its plain "
                                 f"version ({launches} launches, {per_pass} "
                                 "expected)")
        ms = wall_ms(lambda: sop.xtr(R), 3)
        res = cuda_ms(lambda: quad.xtr(R), 3)
        out.update({f"ms_m{m}": ms, f"resident_ms_m{m}": res})
        print(f"[{name}] streamed xtr m={m}: equal to kernel 1 on the "
              f"resident words and to its plain version bit for bit; "
              f"{launches} kernel-1 launches a "
              f"pass ({len(sop._blocks())} blocks"
              f"{' + the prefix' if sop.prefix is not None else ''}); "
              f"{ms:.3f} ms a pass against the link bound {link_ms:.3f} ms "
              f"({streamed_bytes(sop) / 1e9:.3f} GB at the measured "
              f"registered rate; {sheet_ms:.3f} ms at the data sheet's), "
              f"{link_ms / ms:.3f} of it; resident kernel 1 {res:.3f} ms on "
              f"{card}", flush=True)
    W = (rhs_on(g, 1, gen).T > 0).to(torch.float32)
    WY = W * rhs_on(g, 1, gen).T
    for a, b, c in zip(sop.col_moments(W, WY), quad.col_moments(W, WY),
                       plain.col_moments(W, WY)):
        sync()
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"{name}: streamed col_moments differ")
    print(f"[{name}] streamed col_moments (m = 2, S): equal to kernel 1's "
          "and its plain version's bit for bit", flush=True)
    out.update(link_bound_ms=link_ms, sheet_bound_ms=sheet_ms,
               bytes=streamed_bytes(sop), launches=launches)
    return out


def trace_pass(name, sop, g, gen, card, m=100):
    """A ``profiling.trace`` of one streamed pass at width m: its wall,
    idle share, launches and syncs, the copies' and kernel 1's device ms
    (the prefix's kernel timed alone by CUDA events), and the heaviest
    device activities; returns {field: value}."""
    R = rhs_on(g, m, gen).T.contiguous()
    sop.xtr(R)
    with profiling.trace(top=16) as s:
        sop.xtr(R)
    copy_ms = sum(ms for n, ms, _ in s["kernels"] if "Memcpy HtoD" in n)
    kern_ms = sum(ms for n, ms, _ in s["kernels"] if "xt_dots" in n)
    pre_ms = 0.0
    if sop.prefix is not None:
        image = kernels.score_image(R.T, want_missing=g.has_missing)
        pre_ms = cuda_ms(lambda: kernels.xt_dots_words_image(
            sop.prefix.words, image, p=sop.p_res), 3)
    print(f"[{name}] traced streamed pass m={m} on {card}: {trace_text(s)}; "
          f"copies {copy_ms:.3f} ms of device time, kernel 1 {kern_ms:.3f} "
          f"ms (the prefix's launch alone {pre_ms:.3f} ms, the blocks' "
          f"{kern_ms - pre_ms:.3f} ms)", flush=True)
    for n, ms, count in s["kernels"]:
        print(f"[{name}]   {ms:9.3f} ms {count:6d}x  {n[:110]}", flush=True)
    if not (copy_ms > 0 or sop.prefix is not None and not sop._blocks()) \
            or kern_ms <= 0:
        raise AssertionError(f"{name}: the trace shows no copy or kernel")
    return {"trace_wall_ms": s["wall_ms"], "trace_idle_share": s["idle_share"],
            "trace_copy_ms": copy_ms, "trace_kernel_ms": kern_ms,
            "trace_prefix_ms": pre_ms, "trace_syncs": s["syncs"],
            "trace_launches": s["launches"]}


def same_fit(a, b):
    return (np.array_equal(a.beta, b.beta) and np.array_equal(a.c, b.c)
            and a.logl == b.logl and a.iter == b.iter)


def entry_fit(y, s):
    """The fit as a user calls it, ``fit_iht(y, s)`` on the genotypes,
    after an operator over them was built: (result, wall s, ms to build
    one more operator, which reuses the registration and the prefix)."""
    t0 = time.perf_counter()
    StreamedPackedOp(s)
    sync()
    t_again = time.perf_counter() - t0
    r, w, _ = timed_fit(y, s, k=K, verbose=False)
    return r, w, t_again


def timed_fit(y, x, **kw):
    """fit_iht with the launches counted from 0: (result, wall s, kernel-1
    launches)."""
    reset_launches()
    t0 = time.perf_counter()
    r = fit_iht(y, x, **kw)
    return r, time.perf_counter() - t0, kernels.LAUNCHES["xt_dots_words"]


@contextlib.contextmanager
def timed_saves():
    """Records (step, wall s, file bytes) of every checkpoint saved in the
    body."""
    saves, save = [], checkpoint.save_state

    def timed(directory, st, step):
        sync()
        t0 = time.perf_counter()
        path = save(directory, st, step)
        saves.append((step, time.perf_counter() - t0, os.path.getsize(path)))
        return path

    checkpoint.save_state = timed
    try:
        yield saves
    finally:
        checkpoint.save_state = save


def phase_stream(g, y, dual_mse, card, gen, link):
    """Out of core at 10k x 1M, every SNP streamed (``resident_bytes=0``,
    STREAM_BLOCK a block): the passes against kernel 1; the Gaussian fit
    (k = 10) equal to the quad-word fit bit for bit; the cv (path 1:20,
    q = 5, the cv phase's folds) equal to the cv phase's mse bit for bit;
    the 3-trait mv fit equal to the resident one; a checkpointed cv
    (checkpoint_every = STREAM_CKPT_EVERY) killed by max_iter =
    STREAM_KILL_AT and resumed, equal to the plain cv, its saves timed;
    a trace of one pass; returns kernel 1's fields and launches."""
    t_phase = time.perf_counter()
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    s, sop, t_host, t_op = stream_of(g, block_bytes=STREAM_BLOCK,
                                     resident_bytes=0)
    print(f"[stream] {N} x {P} in host memory ({s.words.nbytes / 1e9:.2f} GB"
          f", copied there in {t_host:.2f} s), {len(sop._blocks())} blocks "
          f"of {s.block_p} SNPs, nothing resident; operator built (host "
          f"words registered) in {t_op:.2f} s", flush=True)
    out = check_stream_passes("stream", sop, quad, gen, link, card)
    launches = {"pass": out.pop("launches")}
    out.update(trace_pass("stream", sop, g, gen, card))

    r0, w0, _ = timed_fit(y, quad, k=K, verbose=False)
    sop.syncs = sop.copies = 0
    r1, w1, launches["fit"] = timed_fit(y, sop, k=K, verbose=False)
    r2, w2, t_again = entry_fit(y, s)
    same = same_fit(r0, r1) and same_fit(r0, r2)
    print(f"[stream] streamed fit k={K}: {w1:.3f} s ({w0:.3f} s resident) "
          f"on {card}; iter {r1.iter}, logl {r1.logl}; betas, c, iterations "
          f"and logl equal to the quad-word fit's bit for bit {same}; "
          f"kernel-1 launches {launches['fit']}, {sop.copies} block copies, "
          f"{sop.syncs} index fetches of the forward products; "
          f"fit_iht(y, genotypes) {w2:.3f} s (its operator over the "
          f"registered words; another built in {t_again * 1e3:.2f} ms)",
          flush=True)
    if not same or launches["fit"] < r1.iter + 1:
        raise AssertionError("stream: the streamed fit differs")
    out.update(fit_s=w1, fit_entry_s=w2)

    sop.syncs = sop.copies = 0
    mse, wall, counts, st = run_cv(sop, y)
    launches["cv"] = counts["xt_dots_words"]
    del st
    same = np.array_equal(mse, dual_mse)
    print(f"[stream] streamed cv path 1:{CV_PATH[-1]} q={CV_Q}: {wall:.3f} s "
          f"on {card}; mse equal to the cv phase's bit for bit {same}; "
          f"kernel-1 launches {launches['cv']}, kernel-2 "
          f"{counts['xt_dots_words_t']}, {sop.copies} block copies, "
          f"{sop.syncs} index fetches", flush=True)
    if not same or counts["xt_dots_words_t"] or launches["cv"] < 2:
        raise AssertionError("stream: the streamed cv differs")

    Y, _ = mv_response(g, MV_TRAITS, np.random.default_rng(31))
    kw = dict(k=MV_K, d=MvNormal(), init_beta=True, min_iter=MV_MIN_ITER,
              verbose=False)
    a, wa, _ = timed_fit(Y, quad, **kw)
    b, wb, launches["mv fit"] = timed_fit(Y, sop, **kw)
    same = same_fit(a, b) and np.array_equal(a.Sigma, b.Sigma)
    print(f"[stream] streamed 3-trait mv fit k={MV_K} init_beta: {wb:.3f} s "
          f"({wa:.3f} s resident) on {card}; iter {b.iter}, logl {b.logl}; "
          f"B, C, Sigma, logl and iterations equal to the quad-word fit's "
          f"bit for bit {same}; kernel-1 launches {launches['mv fit']}",
          flush=True)
    if not same:
        raise AssertionError("stream: the streamed mv fit differs")

    ck = tempfile.mkdtemp(prefix="mendeliht_ckpt_")
    try:
        with timed_saves() as saves:
            t0 = time.perf_counter()
            run_cv(sop, y, checkpoint_dir=ck,
                   checkpoint_every=STREAM_CKPT_EVERY,
                   max_iter=STREAM_KILL_AT)
            t_kill = time.perf_counter() - t0
            kept = sorted(checkpoint.all_steps(ck))
            mse, wall, counts, _ = run_cv(sop, y, checkpoint_dir=ck,
                                          checkpoint_every=STREAM_CKPT_EVERY)
        same = np.array_equal(mse, dual_mse)
        text = ", ".join(f"step {st_} {w:.2f} s {nb / 1e9:.3f} GB"
                         for st_, w, nb in saves)
        print(f"[stream] checkpointed streamed cv (every "
              f"{STREAM_CKPT_EVERY}) killed by max_iter={STREAM_KILL_AT} "
              f"after {t_kill:.3f} s (steps kept {kept}), resumed in "
              f"{wall:.3f} s: mse equal to the plain cv's bit for bit "
              f"{same}; saves: {text}", flush=True)
        if not same or kept != [5, STREAM_KILL_AT - 1]:
            raise AssertionError("stream: the resumed cv differs")
        out.update(ckpt_save_s=max(w for _, w, _ in saves),
                   ckpt_bytes=max(nb for _, _, nb in saves))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    out = {f"stream_{k}": v for k, v in out.items()}
    del sop, s
    gc.collect()
    print(f"[stream] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out, launches


def samples_times(g, copies):
    """Genotypes of ``copies`` x g's samples, each sample of g ``copies``
    times, made on g's device from its words: byte columns that hold four
    samples first, then those whose crumb 3 is padding, each run repeated,
    so every crumb plane but the last is whole and the new padding falls
    past the last sample.  mu and 1/sd are g's, bit for bit (each count
    ``copies`` times its own)."""
    n4 = g.words.shape[1]
    full = g.n - 3 * n4                   # columns with four real samples
    n_new, n4_new = copies * g.n, copies * n4
    if not 0 < full <= n4 or n4_new != snparray._ceil_to(
            -(-n_new // 4), snparray._LANE) or n_new - 3 * n4_new != \
            copies * full:
        raise ValueError(f"{g.n} samples do not repeat {copies} times")
    parts = [g.words[:, :full]] * copies + [g.words[:, full:]] * copies
    return PackedGenotypes(words=torch.cat(parts, dim=1), mu=g.mu,
                           inv_sd=g.inv_sd, n=n_new, p=g.p,
                           has_missing=g.has_missing)


def phase_hybrid(g, causal, beta, card, gen, link):
    """The JAX package's out-of-core configuration (STREAM.json): 80,000 x
    1M (8 copies of the 10k samples, 20.48 GB packed) at the default
    budget (``MENDELIHT_STREAM_RESIDENT_BYTES`` unset: 10 GiB resident, 1
    GiB blocks), y from ``phenotype()``: the passes equal to kernel 1 on
    the resident words, the streamed fit equal to the resident quad-word
    fit bit for bit, and a trace of a pass split into the prefix's kernel,
    the copies and the blocks' kernels; returns kernel 1's fields and
    launches."""
    t_phase = time.perf_counter()
    os.environ.pop("MENDELIHT_STREAM_RESIDENT_BYTES", None)
    g8 = samples_times(g, HYBRID_COPIES)
    y8 = phenotype(g8, causal, beta, 9)
    quad = PackedOp(g8)
    s, sop, t_host, t_op = stream_of(g8)
    print(f"[hybrid] {g8.n} x {P} ({s.words.nbytes / 1e9:.2f} GB packed) "
          f"copied to host memory in {t_host:.2f} s; default budget: "
          f"{sop.p_res} SNPs resident ({sop.prefix.words.numel() * 4 / 1e9:.2f}"
          f" GB), {len(sop._blocks())} blocks of {s.block_p} SNPs "
          f"({streamed_bytes(sop) / 1e9:.2f} GB streamed a pass); operator "
          f"built ({s.words.nbytes / 1e9:.2f} GB registered, the prefix "
          f"uploaded) in {t_op:.2f} s",
          flush=True)
    passes = check_stream_passes("hybrid", sop, quad, gen, link, card)
    pass_launches = passes.pop("launches")
    out = {f"hybrid_{k}": v for k, v in passes.items()}
    out.update({f"hybrid_{k}": v for k, v in trace_pass(
        "hybrid", sop, g8, gen, card).items()})
    r0, w0, _ = timed_fit(y8, quad, k=K, verbose=False)
    sop.syncs = sop.copies = 0
    r1, w1, launches = timed_fit(y8, sop, k=K, verbose=False)
    r2, w2, t_again = entry_fit(y8, s)
    same = same_fit(r0, r1) and same_fit(r0, r2)
    found = len(set(np.flatnonzero(r1.beta)) & set(causal.tolist()))
    print(f"[hybrid] streamed fit k={K}: {w1:.3f} s ({w0:.3f} s resident) on "
          f"{card}; iter {r1.iter}, logl {r1.logl}, causal recovered "
          f"{found}/{K}; equal to the resident quad-word fit bit for bit "
          f"{same}; kernel-1 launches {launches}, {sop.copies} block copies, "
          f"{sop.syncs} index fetches; fit_iht(y, genotypes) {w2:.3f} s "
          f"(its operator over the registered words and the uploaded "
          f"prefix; another built in {t_again * 1e3:.2f} ms)", flush=True)
    if not same or launches < r1.iter + 1:
        raise AssertionError("hybrid: the streamed fit differs")
    out.update(hybrid_fit_s=w1, hybrid_fit_entry_s=w2)
    del sop, s, quad, g8
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hybrid] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out, {"hybrid pass": pass_launches, "hybrid fit": launches}


F64 = torch.float64


def rhs64_on(g, m, gen):
    """A float64 R (n_pad, m) on g's device, zero past the samples."""
    rhs = torch.randn((g.n_pad, m), generator=gen, device=g.device,
                      dtype=F64)
    rhs[g.n:] = 0.0
    return rhs


def f64_bound(g, m, planes):
    """Bound of one float64 score pass at width m with ``planes`` output
    planes: the words, R (float64) and the (8m, p) int32 digit sums of
    each plane moved once; 8 digit rows x 2*n_pad*p*m int8 operations a
    plane (the eight 7-bit digits that carry R's 53 bits; the kernel's
    ninth, zero row of the pseudo-column layout is its own cost, not the
    function's)."""
    digits = decode.DIGITS64
    nbytes = (g.words.numel() * 4 + 8 * g.n_pad * m
              + planes * 4 * digits * m * g.p)
    return bound(g.device, nbytes, planes * digits * 2 * g.n_pad * g.p * m,
                 "int8")


def check_f64_sums(label, g, rhs, kw, chunk=250_000):
    """Kernels 2 and 1's float64 entries before the combine
    (``kernels.raw_sums64``) bit for bit against the plain digit sums
    (``decode.digit_sums64``), compared a chunk of SNPs at a time."""
    for transposed, arr in ((True, g.words_t), (False, g.words)):
        raw = kernels.raw_sums64(arr, rhs, transposed=transposed, **kw)
        for lo in range(0, g.p, chunk):
            hi = min(lo + chunk, g.p)
            quads = g.words[lo // 4:-(-hi // 4)]
            plain, _ = decode.digit_sums64(decode.quad_rows(quads),
                                           4 * quads.shape[0], rhs, **kw)
            for r, w in zip(raw, plain):
                if r is not None and not torch.equal(
                        r[lo:hi].to(F64), w[:hi - lo]):
                    which = "kernel 2" if transposed else "kernel 1"
                    raise AssertionError(f"{label}: {which}'s float64 digit "
                                         f"sums differ from plain at SNPs "
                                         f"{lo}..{hi}")
            del plain
        del raw


def f64_widths(label, g, gen, widths):
    """Kernels 2 and 1's float64 entries at each (m, with S) of ``widths``
    on ``g`` (its missing plane where it misses calls; with S on the R
    that col_moments makes, else a random float64 R): the digit sums bit
    for bit against plain (``check_f64_sums``), the float64 scores bit for
    bit against the plain float64 score and each other, and within
    1e-13 * n_pad * max|R_col| of the unquantised float64
    ``decode.xt_dots``; then timed in turns (plain; kernel 2, kernel 1,
    kernel 1, kernel 2; the raw-sum entry alone, ``raw_sums64``, no
    combine, in the same turns; plain) beside the bound.  Returns each
    entry's fields for the kernels line, keyed like ``paired_widths``'."""
    out = {"xt_dots_words_f64": {}, "xt_dots_words_t_f64": {}}
    for m, sq in widths:
        kw = dict(want_missing=g.has_missing, want_sq=sq)
        key = (f"m{m}{'_sq' if sq else ''}"
               f"{'_missing' if g.has_missing else ''}")
        rhs = (moments_rhs(g, m, gen).to(F64) if sq
               else rhs64_on(g, m, gen))
        check_f64_sums(label, g, rhs, kw)
        kwp = dict(kw, p=g.p)
        ref, plain_ms = timed_call(lambda: decode.xt_dots_words(
            g.words, rhs, **kwp))
        exact = decode.xt_dots(g.words, rhs, **kwp)
        scale = g.n_pad * rhs.abs().amax(dim=0).clamp(min=1e-300)
        worst = max(float(((a - e).abs() / scale[None, :]).max())
                    for a, e in zip(ref, exact) if a is not None)
        del exact
        if not worst <= 1e-13:
            raise AssertionError(f"{label}: the float64 score is "
                                 f"{worst:.3g} x n_pad max|R| from the "
                                 f"unquantised one at m={m}")
        calls, raw_calls = {}, {}
        for name, kern, arr, tr in (
                ("xt_dots_words_t_f64", kernels.xt_dots_words_t, g.words_t,
                 True),
                ("xt_dots_words_f64", kernels.xt_dots_words, g.words, False)):
            calls[name] = (lambda k=kern, a=arr: k(a, rhs, **kwp))
            raw_calls[name] = (lambda a=arr, t=tr: kernels.raw_sums64(
                a, rhs, transposed=t, **kw))
            got = calls[name]()
            if not all(same(a, b) for a, b in zip(got, ref) if b is not None):
                raise AssertionError(f"{label}: {name} at m={m} differs from "
                                     "the plain float64 score")
            del got
        del ref
        reps = 10 if m <= 8 else 3
        times = {}
        plain_runs = [plain_ms]
        for what, fns in (("", calls), ("raw_", raw_calls)):
            r2 = [cuda_ms(fns["xt_dots_words_t_f64"], reps)]
            r1 = [cuda_ms(fns["xt_dots_words_f64"], reps),
                  cuda_ms(fns["xt_dots_words_f64"], reps)]
            r2.append(cuda_ms(fns["xt_dots_words_t_f64"], reps))
            times[what] = {"xt_dots_words_t_f64": r2, "xt_dots_words_f64": r1}
        # plain again after the kernels: plain, kernels, plain in turns
        plain_runs.append(timed_call(lambda: decode.xt_dots_words(
            g.words, rhs, **kwp))[1])
        plain_ms = sum(plain_runs) / 2
        b = f64_bound(g, m, 1 + sq + g.has_missing)
        for name in out:
            runs, raw = times[""][name], times["raw_"][name]
            ms, raw_ms = sum(runs) / 2, sum(raw) / 2
            out[name].update({f"ms_{key}": ms, f"raw_ms_{key}": raw_ms,
                              f"plain_ms_{key}": plain_ms,
                              f"bound_ms_{key}": b["bound_ms"],
                              f"bound_by_{key}": b["bound_by"],
                              f"max_abs_err_{key}": 0.0,
                              f"unquantised_err_{key}": worst})
            print(f"[{label}] {name} {g.n} x {g.p} m={m} sq={sq} missing="
                  f"{g.has_missing}: digit sums and score bit-equal to plain "
                  f"and to the other kernel, {worst:.3g} x n_pad max|R| from "
                  f"the unquantised float64 score; {ms:.3f} ms (runs "
                  f"{runs[0]:.3f}, {runs[1]:.3f}), raw-sum entry alone "
                  f"{raw_ms:.3f} ms (runs {raw[0]:.3f}, {raw[1]:.3f}), plain "
                  f"{plain_ms:.3f} ms (one call before the kernels, one "
                  f"after: {plain_runs[0]:.3f}, {plain_runs[1]:.3f}), bound "
                  f"{b['bound_ms']:.3f} ms "
                  f"({b['bound_by']}), {b['bound_ms'] / raw_ms:.3f} of it by "
                  "the raw-sum entry", flush=True)
    return out


def f64_fit(y, x, **kw):
    """(result, wall s, launches of every kernel from 0, peak GiB) of one
    float64 fit_iht."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = fit_iht(y, x, k=K, verbose=False, dtype=F64, **kw)
    wall = time.perf_counter() - t0
    return (r, wall, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_allocated() / 2**30)


def f64_fit_line(label, r, wall, launches, peak, causal, card):
    sel = np.flatnonzero(r.beta)
    found = len(set(sel) & set(causal.tolist()))
    print(f"[float64] {label} {N} x {P} k={K} on {card}: iter {r.iter}, "
          f"logl {r.logl}, support {sel.tolist()}, causal recovered "
          f"{found}/{K}, wall {wall:.4f} s, launches "
          f"{launches['xt_dots_words_t_f64']} (kernel 2 float64), "
          f"{launches['xt_dots_words_f64']} (kernel 1 float64), "
          f"{launches['xt_dots_words_t'] + launches['xt_dots_words']} (f32), "
          f"peak {peak:.2f} GiB", flush=True)
    if (r.beta.dtype != np.float64 or len(sel) != K
            or not np.isfinite(r.logl)
            or launches["xt_dots_words_t"] + launches["xt_dots_words"]):
        raise AssertionError(f"float64 {label} failed its checks")
    return set(sel.tolist()), found


def phase_float64(g, causal, y, card, dual_mse):
    """Float64 fits at the reference's headline size, 10k x 1M: kernels 2
    and 1's float64 entries against plain at m = 1, 8, 100 and 200 with S
    (``f64_widths``); the Gaussian fit (k = 10) on both layouts, cold and
    F64_WARM warm, identical, with the f32 fit's support and 10/10 causal;
    the cv (path 1:20, q = 5, the cv phase's folds) on both layouts, cold
    and warm, the mse equal bit for bit between them and the f32 cv's best
    k; the init_beta fit; the Bernoulli fit beside the f32 one (support
    and iterations: ROADMAP Queue 3's check); a ``profiling.trace`` of a
    warm float64 cv and fit.  Returns the two entries' fields for the
    kernels line."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=g.device).manual_seed(SEED + 64)
    out = f64_widths("float64", g, gen, [(m, False) for m in F64_WIDTHS]
                     + [(MOMENT_WIDTHS[1], True)])
    f32 = fit_iht(y, g, k=K, verbose=False)
    f32_sel = set(np.flatnonzero(f32.beta).tolist())
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    fits = {}
    for layout, x, warm in (("dual", g, F64_WARM), ("quad", quad, 1)):
        walls = []
        for run in range(1 + warm):
            r, wall, launches, peak = f64_fit(y, x)
            walls.append(wall)
            if run == 0:
                sel, found = f64_fit_line(f"{layout} fit (cold)", r, wall,
                                          launches, peak, causal, card)
            elif (np.flatnonzero(r.beta).tolist(), r.iter, r.logl) != (
                    sorted(sel), fits[layout][1], fits[layout][2]):
                raise AssertionError(f"float64 {layout} warm fit differs")
            fits[layout] = (r.beta, r.iter, r.logl, launches)
        w = np.array(walls[1:])
        print(f"[float64] {layout} fit: {warm} warm, median "
              f"{np.median(w):.4f} s, range {w.min():.4f}-{w.max():.4f} s; "
              f"the f32 fit's support {sel == f32_sel} (f32: iter "
              f"{f32.iter})", flush=True)
        if sel != f32_sel or found != K:
            raise AssertionError(f"float64 {layout} fit: support differs "
                                 "from the f32 fit's or misses a causal SNP")
    if not (np.array_equal(fits["dual"][0], fits["quad"][0])
            and fits["dual"][1:3] == fits["quad"][1:3]):
        raise AssertionError("float64 quad and dual fits differ")
    out["xt_dots_words_f64"]["launches"] = \
        fits["quad"][3]["xt_dots_words_f64"]
    out["xt_dots_words_t_f64"]["fit_launches"] = \
        fits["dual"][3]["xt_dots_words_t_f64"]
    f32_best = CV_PATH[int(np.argmin(dual_mse))]
    mses = {}
    for layout, x, warm in (("dual", g, 1), ("quad", quad, 0)):
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for run in range(1 + warm):
            mse, wall, counts, st = run_cv(x, y, dtype=F64)
            iters = st.iters.cpu().numpy()
            del st
            walls.append(wall)
            if run and not np.array_equal(mse, mses[layout]):
                raise AssertionError(f"float64 {layout} warm cv differs")
            mses[layout] = mse
        peak = torch.cuda.max_memory_allocated() / 2**30
        best = CV_PATH[int(np.argmin(mse))]
        name = "xt_dots_words_t_f64" if layout == "dual" else \
            "xt_dots_words_f64"
        print(f"[float64] {layout} cv {N} x {P} path 1:{CV_PATH[-1]} "
              f"q={CV_Q} on {card}: cold {walls[0]:.4f} s, warm "
              f"{walls[1:]}, best k {best} (f32 {f32_best}), tasks converged "
              f"{int((iters < CV_MAX_ITER).sum())}/{len(iters)}, the last at "
              f"{iters.max()}, {counts[name]} {name} launches, "
              f"{counts['xt_dots_words_t'] + counts['xt_dots_words']} f32, "
              f"peak {peak:.2f} GiB; mse "
              f"{np.array2string(mse, precision=9, max_line_width=500)}",
              flush=True)
        if (mse.dtype != np.float64 or not np.isfinite(mse).all()
                or best != f32_best or counts[name] < 2
                or counts["xt_dots_words_t"] + counts["xt_dots_words"]):
            raise AssertionError(f"float64 {layout} cv failed its checks")
        out[name]["cv_launches"] = counts[name]
    if not np.array_equal(mses["dual"], mses["quad"]):
        raise AssertionError("float64 quad and dual cvs differ")
    out["xt_dots_words_t_f64"]["launches"] = \
        out["xt_dots_words_t_f64"]["cv_launches"]
    r, wall, launches, peak = f64_fit(y, g, init_beta=True)
    f64_fit_line("init_beta fit", r, wall, launches, peak, causal, card)
    out["xt_dots_words_t_f64"]["init_beta_launches"] = \
        launches["xt_dots_words_t_f64"]
    yb, _, causal_b = simulate_random_response(
        g, K, Bernoulli(), LogitLink(), rng=np.random.default_rng(SEED))
    rb32 = fit_iht(yb, g, k=K, d=Bernoulli(), l=LogitLink(), verbose=False)
    rb, wall, launches, peak = f64_fit(yb, g, d=Bernoulli(), l=LogitLink())
    sel_b, _ = f64_fit_line("Bernoulli fit", rb, wall, launches, peak,
                            causal_b, card)
    sel_b32 = set(np.flatnonzero(rb32.beta).tolist())
    print(f"[float64] Queue 3 check: the f32 Bernoulli fit on the card (R "
          f"through 21-bit digits) {rb32.iter} iterations, logl "
          f"{rb32.logl}; the float64 one (the exact float64 score) "
          f"{rb.iter} iterations, logl {rb.logl}; same support "
          f"{sel_b == sel_b32} (only f32: {sorted(sel_b32 - sel_b)}, only "
          f"float64: {sorted(sel_b - sel_b32)})", flush=True)
    out["xt_dots_words_t_f64"]["bernoulli_launches"] = \
        launches["xt_dots_words_t_f64"]
    phase_profile(g, y, card, calls=(
        ("float64 cv", "xt_dots_t", lambda: run_cv(g, y, dtype=F64)),
        ("float64 fit", "xt_dots_t",
         lambda: fit_iht(y, g, k=K, verbose=False, dtype=F64))))
    print(f"[float64] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


def phase_float64_parity(card_g, cpu_g, y):
    """The float64 fit (k = 10) at 2,000 x 20,000 on the card (kernel 2's
    float64 entry) and on the CPU (the unquantised float64 score): the same
    support and iterations, beta within 1e-9 of max|beta|."""
    a = fit_iht(y, card_g, k=K, verbose=False, dtype=F64)
    b = fit_iht(y, cpu_g, k=K, verbose=False, dtype=F64)
    err = float(np.abs(a.beta - b.beta).max() / np.abs(b.beta).max())
    same_sel = set(np.flatnonzero(a.beta)) == set(np.flatnonzero(b.beta))
    print(f"[float64-parity] n={card_g.n} p={card_g.p} k={K}: cuda iter "
          f"{a.iter} logl {a.logl}, cpu iter {b.iter} logl {b.logl}, same "
          f"support {same_sel}, beta within {err:.3g} of max|beta|",
          flush=True)
    if not (same_sel and a.iter == b.iter and err <= F64_PARITY_TOL
            and a.beta.dtype == np.float64):
        raise AssertionError("float64 card and CPU fits disagree")


def phase_float64_missing(g, y, card, f32_mse):
    """On the genotypes with missing calls: kernels 2 and 1's float64
    entries with M at m = 100, then the float64 cv (path 1:20, q = 5) with
    the f32 cv-miss's best k; returns the entries' fields."""
    gen = torch.Generator(device=g.device).manual_seed(SEED + 65)
    out = f64_widths("float64-miss", g, gen, [(100, False)])
    torch.cuda.reset_peak_memory_stats()
    mse, wall, counts, st = run_cv(g, y, dtype=F64)
    iters = st.iters.cpu().numpy()
    del st
    best, f32_best = (CV_PATH[int(np.argmin(v))] for v in (mse, f32_mse))
    print(f"[float64-miss] cv {N} x {P} with missing calls on {card}: "
          f"{wall:.4f} s, best k {best} (f32 {f32_best}), iterations "
          f"{iters.max()}, {counts['xt_dots_words_t_f64']} kernel-2 float64 "
          f"launches, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          "GiB", flush=True)
    if (not np.isfinite(mse).all() or best != f32_best
            or counts["xt_dots_words_t_f64"] < 2):
        raise AssertionError("float64 cv with missing calls failed its "
                             "checks")
    out["xt_dots_words_t_f64"]["missing_cv_launches"] = \
        counts["xt_dots_words_t_f64"]
    return out


def main(dev=None):
    """Every phase on ``dev`` (default the first CUDA device)."""
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0) if dev is None else dev
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    small = [genotypes(np.random.default_rng(1), N, P_KERNEL, True, dev)[0],
             genotypes(np.random.default_rng(2), N_DEEP, P_DEEP, True, dev)[0]]
    t0 = time.perf_counter()
    g, causal, beta = genotypes(np.random.default_rng(SEED), N, P, False, dev)
    print(f"[data] generated {N} x {P} ({g.words.numel() * 4 / 1e9:.2f} GB "
          f"packed) in {time.perf_counter() - t0:.1f} s", flush=True)
    k1 = phase_kernel(small, g, gen)
    k2 = phase_kernel_t(small, g, gen)
    moments = moment_widths("moments", g, gen)
    k6 = phase_kernel_i8(small, g, gen)
    check_rounds(small, gen)
    del small
    k3 = phase_probe(g)
    card_g, cpu_g, y_par = phase_parity(dev)
    phase_cv_parity(card_g, cpu_g, y_par)
    phase_family_parity(card_g, cpu_g)
    phase_option_parity(card_g, cpu_g, y_par)
    phase_mv_parity(card_g, cpu_g)
    phase_float64_parity(card_g, cpu_g, y_par)
    del card_g, cpu_g
    y = phenotype(g, causal, beta, 7)
    k1["launches"], _ = phase_fit(g, causal, y, card)
    k2["launches"], dual_mse = phase_cv("cv", g, y, card, warm=CV_WARM)
    k1["cv_launches"] = phase_cv_quad(g, y, card, dual_mse)
    k1["sharded_launches"] = phase_sharded(g, y, card, dual_mse, gen)
    phase_profile(g, y, card)
    labs = phase_lab(g, card)
    kprobe, probe_launches = phase_kprobe(g, card, gen)
    phase_sharded_profile(g, y, card)
    k1.update(int8_bound_of(g, missing=False)(1), library_ms=None)
    k2.update(int8_bound_of(g, missing=False)(100), library_ms=None)
    print(f"[kernel-t] m=100: kernel 1 {k1['ms_m100']:.3f} ms, kernel 2 "
          f"{k2['ms']:.3f} ms, kernel 6 {k6['ms']:.3f} ms in this run",
          flush=True)
    if not k6["ms"] <= SAME_BODY_SLACK * k2["ms"]:
        raise AssertionError(f"kernel 6 ({k6['ms']:.3f} ms) is more than "
                             f"{SAME_BODY_SLACK - 1:.0%} slower than kernel 2 "
                             f"({k2['ms']:.3f} ms), its own body, at m = 100")
    fam = phase_families(g, card)
    k1["family_launches"] = fam["xt_dots_words"]
    k2["family_launches"] = fam["xt_dots_words_t"]
    opts = phase_options(g, causal, y, card)
    mvl, mvw = phase_mv(g, card, gen)
    # after the lab: its device_ms needs whole profiler traces, which lose
    # kernel records more often the more profiler sessions ran before it
    f64 = phase_float64(g, causal, y, card, dual_mse)
    k2["io_launches"] = phase_io(g, y, dual_mse, card, dev)
    phase_dense(g, causal, y, card, dev)
    link = phase_hostlink(dev, card)
    stream, k1["stream_launches"] = phase_stream(g, y, dual_mse, card, gen,
                                                 link)
    hybrid, hybrid_launches = phase_hybrid(g, causal, beta, card, gen, link)
    k1["stream_launches"].update(hybrid_launches)
    k1.update(stream, **hybrid)
    for st, name in ((k1, "xt_dots_words"), (k2, "xt_dots_words_t")):
        st.update(moments[name])
        st.update(mvw[name], options_launches=opts[name],
                  mv_launches=mvl[name])
    del g
    gm, causal_m, beta_m = genotypes(np.random.default_rng(SEED + 1), N, P,
                                     True, dev)
    y_m = phenotype(gm, causal_m, beta_m, 8)
    miss = phase_missing(gm, y_m, card, gen)
    for name, fields in phase_float64_missing(gm, y_m, card,
                                              miss["mse"]).items():
        f64[name].update(fields)
    wrapper_launches(gm, gen)
    for st, name in ((k1, "xt_dots_words"), (k2, "xt_dots_words_t")):
        ms, plain_ms, err, abs_err, bound_ms = miss[name]
        st.update(miss["moments"][name])
        st.update(ms_m100_missing=ms, plain_ms_m100_missing=plain_ms,
                  bound_ms_m100_missing=bound_ms,
                  max_rel_err=max(st["max_rel_err"], err),
                  max_abs_err=max(st["max_abs_err"], abs_err))
    del gm
    torch.cuda.empty_cache()
    for name, fields in phase_budget(dev, card).items():
        (k1 if name == "xt_dots_words" else k2).update(fields)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    k4 = dict(labs["unpack"], launches=labs["launches"]["unpack_words"])
    k5 = dict(labs["dot"], launches=labs["launches"]["int_dot_packed"])
    k6["launches"] = labs["launches"]["xt_dots_T"]
    # the float64 entries' main widths: kernel 1's quad-word fit (m = 1),
    # kernel 2's cv (m = 100); whole float64 score calls, as the f32 rows
    for name, m in (("xt_dots_words_f64", 1), ("xt_dots_words_t_f64", 100)):
        st = f64[name]
        st.update(m=m, ms=st[f"ms_m{m}"], plain_ms=st[f"plain_ms_m{m}"],
                  bound_ms=st[f"bound_ms_m{m}"], bound_by=st[f"bound_by_m{m}"],
                  max_abs_err=0.0, library_ms=None)
    stats = {"xt_dots_words": k1, "xt_dots_words_t": k2, "read_words": k3,
             "unpack_words": k4, "int_dot_packed": k5, "xt_dots_T": k6,
             **f64}
    for name, st in kprobe.items():
        stats[name] = dict(st, launches=probe_launches[name])
    print(json.dumps({"kernels": [
        dict(name=name, **KERNELS[name], **st,
             lab_launches=labs["launches"].get(name, 0),
             probe_launches=probe_launches.get(name, 0))
        for name, st in stats.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
