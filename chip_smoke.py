#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mendeliht_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises (non-zero exit, no
result line):

1. device     name, ``nvidia-smi`` name and power limit; TF32 off
2. build      the three CUDA sources of ``mendeliht_tpu_torch/csrc``, one
              nvcc each, all started together; ptxas register/spill lines
3. kernel     kernel 1 (``xt_dots_words``, quad words) vs its plain PyTorch
              version on the card: n=10k x p=65,536 and n=200k x p=4,096
              (long per-SNP sums), both with missing genotypes, at m in
              {1, 8, 100} for every output combination, a NaN column; at
              10k x 1M kernel and plain at m in {1, 8, 100}, each checked
              (relative and absolute error) and timed
4. kernel-t   kernel 2 (``xt_dots_words_t``, transposed dual layout): the
              same cases against its plain version, ``build_words_t`` on the
              card equal to the CPU and its time at 10k x 1M, kernels 2 and
              1 against each other at 10k x 1M
5. probe      kernel 3 (``read_words``) equal to its plain version on the
              10k x 1M words; the read ceiling through the profiling entry
              point, the plain rate, and ``kernel_roofline`` of both layouts
              at m in {1, 100}
6. parity     the same port fit (n=2,000, p=20,000, k=10) on the card and on
              the CPU: same support and iteration count
7. cv-parity  the same ``cv_iht`` (2,000 x 20,000, path 1:10, q=3, fixed
              folds) on the card and on the CPU: mse within 1e-4, same best k
8. fit        ``fit_iht`` at 10k x 1M, k=10 (the JAX package's headline
              size) through ``PackedOp`` (quad words, kernel 1) and through
              the genotypes (dual layout, kernel 2), cold then FIT_WARM warm
              runs each: same support and iterations, logl within 1e-5,
              causal recovery, the warm median and range
9. cv         ``cv_iht`` at 10k x 1M, path 1:20, q=5 (B=100 tasks, every
              score pass at m=100) on its default path, cold then CV_WARM
              warm runs on the same folds: finite mse, best k, iterations
              from the solver state, kernel-2 launches, peak memory
10. profile   ``profiling.trace`` over one warm cv and one warm dual fit:
              wall, device busy and idle share, launches, syncs, the
              heaviest device kernels
11. cv-miss   the same cv on 10k x 1M genotypes with missing calls (the
              score with its missing plane), after kernel 2 vs plain and
              timed at m=100 on them
12. result    a JSON line of the kernels, then ``{"ok": true, "device": ...}``

Kernel launch counts in the kernels line come from the runs of the paths
each kernel serves, with the counts set to 0 just before: the quad-word fit
(kernel 1), the cv (kernel 2) and the read-ceiling measurement (kernel 3).

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

import contextlib
import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mendeliht_tpu_torch import PackedGenotypes, cv_iht, fit_iht
from mendeliht_tpu_torch.models import univariate
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.ops.linalg import PackedOp
from mendeliht_tpu_torch.utils import profiling
from mendeliht_tpu_torch.utils.simulate import simulate_packed_problem

N, P, K = 10_000, 1_000_000, 10          # the JAX package's headline fit
P_KERNEL = 65_536                        # SNPs of the kernel-vs-plain cases
N_DEEP, P_DEEP = 200_000, 4_096          # long per-SNP sums
N_PARITY, P_PARITY = 2_000, 20_000       # the card-vs-CPU fit and cv
CV_PATH, CV_Q = list(range(1, 21)), 5    # the reference-shaped cv grid
FIT_WARM, CV_WARM = 10, 5                # warm runs after the cold one
CV_MAX_ITER = 100                        # cv_iht's default
SEED = 2026
TOL = 2e-5         # the bound tests/test_pallas.py holds the Pallas kernels to
CV_TOL = 1e-4      # cv mse, card vs CPU: f32 sums in another order
SOURCES = ("xt_dots", "xt_dots_t", "read_probe")
KERNELS = {
    "xt_dots_words": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:157"),
    "xt_dots_words_t": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/xt_dots_t.cu",
        replaces="mendeliht_tpu/ops/pallas_kernels.py:398"),
    "read_words": dict(
        route="cuda", source="mendeliht_tpu_torch/csrc/read_probe.cu",
        replaces="mendeliht_tpu/utils/profiling.py:68"),
}


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


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


def check_cases(name, kernel, plain, arr, g, gen):
    """Kernel vs plain on the same card tensors at m in {1, 8, 100} for
    every output combination, then a NaN column; returns the worst error."""
    worst = 0.0
    for m in (1, 8, 100):
        rhs = rhs_on(g, m, gen)
        for want_missing in (False, True):
            for want_sq in (False, True):
                kw = dict(want_missing=want_missing, want_sq=want_sq, p=g.p)
                got, ref = kernel(arr, rhs, **kw), plain(arr, rhs, **kw)
                sync()
                err = max(rel_err(a, b) for a, b in zip(got, ref)
                          if b is not None)
                print(f"[{name}] n={g.n} p={g.p} m={m} missing={want_missing} "
                      f"sq={want_sq}: rel err {err:.3g}", flush=True)
                if not err < TOL:
                    raise AssertionError(f"{name} disagrees: {err} >= {TOL}")
                worst = max(worst, err)
    rhs = rhs_on(g, 8, gen)
    rhs[123, 3] = float("nan")
    kw = dict(want_missing=True, want_sq=True, p=g.p)
    for out in (*kernel(arr, rhs, **kw), *plain(arr, rhs, **kw)):
        if not (torch.isnan(out[:, 3]).all()
                and torch.isfinite(out[:, [0, 1, 2, 4, 5, 6, 7]]).all()):
            raise AssertionError(f"{name}: NaN not confined to column 3")
    print(f"[{name}] NaN in column 3: kernel and plain NaN there, finite "
          "elsewhere", flush=True)
    return worst


def time_widths(name, kernel, plain, arr, g, gen, widths=(1, 8, 100)):
    """Kernel vs plain on ``g`` at each width, with the outputs the score
    pass of a fit or cv asks for: first checked against each other, then
    timed; returns {m: (kernel ms, plain ms, rel err, abs err)}."""
    times = {}
    for m in widths:
        rhs = rhs_on(g, m, gen)
        kw = dict(want_missing=g.has_missing, want_sq=False, p=g.p)
        got, ref = kernel(arr, rhs, **kw), plain(arr, rhs, **kw)
        sync()
        pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
        err = max(rel_err(a, b) for a, b in pairs)
        abs_err = max(float((a - b).abs().max()) for a, b in pairs)
        del got, ref, pairs
        if not err < TOL:
            raise AssertionError(f"{name} disagrees at {g.n} x {g.p}, m={m}: "
                                 f"{err} >= {TOL}")
        ms, plain_ms, runs = interleaved(
            lambda: kernel(arr, rhs, **kw), lambda: plain(arr, rhs, **kw),
            reps=20 if m == 1 else 5, plain_reps=2)
        times[m] = (ms, plain_ms, err, abs_err)
        print(f"[{name}] {g.n} x {g.p} m={m} missing={g.has_missing}: rel err "
              f"{err:.3g}, max abs err {abs_err:.3g}; kernel {ms:.3f} ms (runs "
              f"{runs[0]:.3f}, {runs[1]:.3f}), plain {plain_ms:.3f} ms (runs "
              f"{runs[2]:.3f}, {runs[3]:.3f}) per X'R pass", flush=True)
    return times


def errors(worst, times):
    """The kernels line's error fields: the worst over the small cases
    (relative) and the full-size widths."""
    return dict(max_abs_err=max(t[3] for t in times.values()),
                max_rel_err=max(worst, *(t[2] for t in times.values())))


def phase_kernel(small, g, gen):
    worst = max(check_cases("kernel", kernels.xt_dots_words,
                            decode.xt_dots_words, s.words, s, gen)
                for s in small)
    times = time_widths("kernel", kernels.xt_dots_words,
                        decode.xt_dots_words, g.words, g, gen)
    return dict(**errors(worst, times), ms=times[1][0], plain_ms=times[1][1],
                m=1)


def phase_kernel_t(small, g, gen):
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
    for m in (1, 100):
        rhs = rhs_on(g, m, gen)
        kw = dict(want_missing=False, want_sq=False, p=g.p)
        a = kernels.xt_dots_words_t(g.words_t, rhs, **kw)[0]
        b = kernels.xt_dots_words(g.words, rhs, **kw)[0]
        sync()
        e = rel_err(a, b)
        print(f"[kernel-t] {g.n} x {g.p} m={m}: kernel 2 vs kernel 1 rel err "
              f"{e:.3g}", flush=True)
        if not e < TOL:
            raise AssertionError(f"kernels 2 and 1 disagree: {e}")
    times = time_widths("kernel-t", kernels.xt_dots_words_t,
                        decode.xt_dots_words_t, g.words_t, g, gen)
    return dict(**errors(worst, times), ms=times[100][0],
                plain_ms=times[100][1], m=100,
                ms_m1=times[1][0], plain_ms_m1=times[1][1],
                ms_m8=times[8][0], plain_ms_m8=times[8][1])


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
    return dict(launches=launches, max_abs_err=float((got - ref).abs().max()),
                ms=ms, plain_ms=plain_ms, gbytes_per_s=roof / 1e9)


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
    if sa != sb or a.iter != b.iter:
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


def phase_fit(g, causal, y, card):
    """The 10k x 1M fit through both layouts, cold then FIT_WARM warm runs
    each; returns kernel 1's launches in the last warm quad-word fit."""
    quad = PackedOp(dataclasses.replace(g, words_t=None))
    res = {}
    for layout, x in (("quad", quad), ("dual", g)):
        mine = "xt_dots_words" if layout == "quad" else "xt_dots_words_t"
        other = "xt_dots_words_t" if layout == "quad" else "xt_dots_words"
        walls = []
        for run in range(1 + FIT_WARM):
            for name in kernels.LAUNCHES:
                kernels.LAUNCHES[name] = 0
            t0 = time.perf_counter()
            r = fit_iht(y, x, k=K, verbose=False)
            walls.append(time.perf_counter() - t0)
            launches = dict(kernels.LAUNCHES)
            sel = np.flatnonzero(r.beta)
            found = len(set(sel) & set(causal.tolist()))
            if run == 0:
                print(f"[fit] {layout} cold fit {N} x {P} k={K}: "
                      f"{walls[0]:.4f} s on {card}; iter {r.iter}, logl "
                      f"{r.logl}, causal recovered {found}/{K}, {len(sel)} "
                      f"selected, launches {launches[mine]} ({mine}), "
                      f"{launches[other]} ({other})", flush=True)
            if (len(sel) != K or found < K or launches[mine] < r.iter + 1
                    or launches[other] != 0):
                raise AssertionError(f"{layout} fit failed its checks")
            if run:
                same = (set(sel), r.iter, r.logl) == res[layout][:3]
                if not same:
                    raise AssertionError(f"{layout} warm fit differs from cold")
            res[layout] = (set(sel), r.iter, r.logl, launches[mine])
        warm = np.array(walls[1:])
        print(f"[fit] {layout} {FIT_WARM} warm fits: median "
              f"{np.median(warm):.4f} s, range {warm.min():.4f}-"
              f"{warm.max():.4f} s, each the same result; launches "
              f"{launches[mine]} ({mine}) per fit", flush=True)
    (sq, iq, lq, launches), (sd, idu, ld, _) = res["quad"], res["dual"]
    if sq != sd or iq != idu or not abs(lq - ld) <= 1e-5 * abs(lq):
        raise AssertionError("quad and dual fits disagree")
    print(f"[fit] quad and dual: same support, {iq} iterations, logl "
          f"{lq} vs {ld}", flush=True)
    return launches


@contextlib.contextmanager
def solver_states():
    """Collects the state of every full solve (``univariate.run_iht``);
    cv_iht's default path runs one for all its (fold, k) tasks."""
    states, run_iht = [], univariate.run_iht

    def recording(*args, **kwargs):
        states.append(run_iht(*args, **kwargs))
        return states[-1]

    univariate.run_iht = recording
    try:
        yield states
    finally:
        univariate.run_iht = run_iht


def run_cv(g, y):
    """cv_iht on its default path: (mse, wall s, kernel-2 launches, the
    final solver state)."""
    kernels.LAUNCHES["xt_dots_words_t"] = 0
    with solver_states() as states:
        t0 = time.perf_counter()
        mse = cv_iht(y, g, path=CV_PATH, q=CV_Q, verbose=False,
                     max_iter=CV_MAX_ITER, rng=np.random.default_rng(SEED))
        wall = time.perf_counter() - t0
    return mse, wall, kernels.LAUNCHES["xt_dots_words_t"], states[-1]


def phase_cv(name, g, y, card, warm):
    """cv_iht at the full width, cold then ``warm`` warm runs on the same
    folds; returns kernel 2's launches in the last run."""
    out = []
    torch.cuda.reset_peak_memory_stats()
    for run in range(1 + warm):
        mse, wall, launches, st = run_cv(g, y)
        iters, iteration = st.iters.cpu().numpy(), st.iteration
        del st                  # its (B, p) arrays would raise the next peak
        done = int((iters < CV_MAX_ITER).sum())
        best = CV_PATH[int(np.argmin(mse))]
        out.append((mse, wall))
        if (not np.all(np.isfinite(mse)) or done != len(iters)
                or launches < iteration + 1 or not 8 <= best <= 14):
            raise AssertionError(f"{name} failed its checks: best k {best}, "
                                 f"{done}/{len(iters)} converged, "
                                 f"{launches} launches")
        if run and not np.array_equal(mse, out[0][0]):
            raise AssertionError(f"{name}: a warm run differs from the cold")
        if run == 0:
            print(f"[{name}] cold cv_iht {N} x {P} missing={g.has_missing} "
                  f"path 1:{CV_PATH[-1]} q={CV_Q}: {wall:.4f} s on {card}; "
                  f"{done}/{len(iters)} tasks converged, the last at "
                  f"iteration {iters.max()} ({iteration} iterations "
                  f"run); kernel-2 launches {launches}; best k {best}",
                  flush=True)
            mse_s = np.array2string(mse, precision=6, max_line_width=400)
            print(f"[{name}] mse {mse_s}", flush=True)
    walls = np.array([w for _, w in out[1:]])
    print(f"[{name}] {warm} warm cvs: median {np.median(walls):.4f} s, range "
          f"{walls.min():.4f}-{walls.max():.4f} s, the same mse as the cold "
          f"run; kernel-2 launches {launches} per cv", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{name}] peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)", flush=True)
    return launches


def phase_profile(g, y, card):
    """Where a warm cv's and a warm dual-layout fit's time goes."""
    calls = (("cv", "xt_dots_t", lambda: run_cv(g, y)),
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


def phase_missing(g, y, card, gen):
    """Kernel 2 with its missing plane at the cv width, then the cv, on
    10k x 1M genotypes with missing calls."""
    g.with_dual_layout()
    times = time_widths("cv-miss", kernels.xt_dots_words_t,
                        decode.xt_dots_words_t, g.words_t, g, gen,
                        widths=(100,))
    phase_cv("cv-miss", g, y, card, warm=1)
    return times[100]


def main():
    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
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
    del small
    k3 = phase_probe(g)
    card_g, cpu_g, y_par = phase_parity(dev)
    phase_cv_parity(card_g, cpu_g, y_par)
    del card_g, cpu_g
    y = phenotype(g, causal, beta, 7)
    k1["launches"] = phase_fit(g, causal, y, card)
    k2["launches"] = phase_cv("cv", g, y, card, warm=CV_WARM)
    phase_profile(g, y, card)
    del g
    gm, causal_m, beta_m = genotypes(np.random.default_rng(SEED + 1), N, P,
                                     True, dev)
    ms, plain_ms, err, abs_err = phase_missing(
        gm, phenotype(gm, causal_m, beta_m, 8), card, gen)
    k2.update(ms_m100_missing=ms, plain_ms_m100_missing=plain_ms,
              max_rel_err=max(k2["max_rel_err"], err),
              max_abs_err=max(k2["max_abs_err"], abs_err))
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, **KERNELS[name], **stats)
        for name, stats in (("xt_dots_words", k1), ("xt_dots_words_t", k2),
                            ("read_words", k3))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
