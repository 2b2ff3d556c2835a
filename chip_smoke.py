#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mendeliht_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each, any failure raises (non-zero exit, no result line):

1. device   name, ``nvidia-smi`` name and power limit; TF32 off
2. build    the CUDA kernels from ``mendeliht_tpu_torch/csrc`` with nvcc
3. kernel   ``xt_dots_words`` kernel vs its plain PyTorch version on the
            card: n=10k x p=65,536 with missing genotypes at m in {1, 8, 100}
            for every output combination, a NaN column, and a full
            10k x 1M pass at m=1; times of kernel and plain at 10k x 1M
4. parity   the same port fit (n=2,000, p=20,000, k=10) on the card and on
            the CPU: same support and iteration count
5. main     the port's ``fit_iht`` at 10k x 1M, k=10 (the JAX package's
            headline benchmark size), cold and warm, with causal recovery
            and the kernel's launch count during one fit
6. result   a JSON line of the kernels, then ``{"ok": true, "device": ...}``

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

import json
import subprocess
import time

import numpy as np
import torch

from mendeliht_tpu_torch import PackedGenotypes, fit_iht
from mendeliht_tpu_torch.ops import decode, kernels
from mendeliht_tpu_torch.ops.linalg import PackedOp
from mendeliht_tpu_torch.utils.simulate import simulate_packed_problem

N, P, K = 10_000, 1_000_000, 10          # the JAX package's headline fit
P_KERNEL = 65_536                        # SNPs of the kernel-vs-plain cases
N_PARITY, P_PARITY = 2_000, 20_000       # the card-vs-CPU fit
SEED = 2026
TOL = 2e-5         # the bound tests/test_pallas.py holds the Pallas kernel to
KERNEL = dict(name="xt_dots_words", route="cuda",
              source="mendeliht_tpu_torch/csrc/xt_dots.cu",
              replaces="mendeliht_tpu/ops/pallas_kernels.py:157")


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp(min=1.0))


def both(words, rhs, want_missing, want_sq):
    """(kernel, plain) outputs on the same card tensors."""
    kw = dict(want_missing=want_missing, want_sq=want_sq)
    got = kernels.xt_dots_words(words, rhs, **kw)
    ref = decode.xt_dots_words(words, rhs, **kw)
    torch.cuda.synchronize()
    return got, ref


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    lib = kernels.build_library("xt_dots")
    regs = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {' | '.join(regs)}", flush=True)


def phase_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, _, _ = genotypes(np.random.default_rng(1), N, P_KERNEL, True, dev)
    worst = 0.0
    for m in (1, 8, 100):
        rhs = torch.randn((g.n_pad, m), generator=gen, device=dev)
        rhs[g.n:] = 0.0
        for want_missing in (False, True):
            for want_sq in (False, True):
                got, ref = both(g.words, rhs, want_missing, want_sq)
                err = max(rel_err(a, b) for a, b in zip(got, ref)
                          if b is not None)
                print(f"[kernel] n={N} p={P_KERNEL} m={m} missing={want_missing} "
                      f"sq={want_sq}: rel err {err:.3g}", flush=True)
                if not err < TOL:
                    raise AssertionError(f"kernel disagrees: {err} >= {TOL}")
                worst = max(worst, err)
    rhs = torch.randn((g.n_pad, 8), generator=gen, device=dev)
    rhs[123, 3] = float("nan")
    got, ref = both(g.words, rhs, True, True)
    for a, b in zip(got, ref):
        for out in (a, b):
            if not (torch.isnan(out[:, 3]).all()
                    and torch.isfinite(out[:, [0, 1, 2, 4, 5, 6, 7]]).all()):
                raise AssertionError("NaN column not confined to column 3")
    print("[kernel] NaN in column 3: kernel and plain NaN there, finite "
          "elsewhere", flush=True)
    del g, got, ref

    t0 = time.perf_counter()
    g, causal, beta = genotypes(np.random.default_rng(SEED), N, P, False, dev)
    print(f"[kernel] generated {N} x {P} ({g.words.numel() * 4 / 1e9:.2f} GB "
          f"packed) in {time.perf_counter() - t0:.1f} s", flush=True)
    rhs1 = torch.randn((g.n_pad, 1), generator=gen, device=dev)
    rhs1[g.n:] = 0.0
    got, ref = both(g.words, rhs1, False, False)
    err = rel_err(got[0], ref[0])
    abs_err = float((got[0] - ref[0]).abs().max())
    print(f"[kernel] full {N} x {P} pass m=1: rel err {err:.3g}, "
          f"max abs err {abs_err:.3g}", flush=True)
    if not err < TOL:
        raise AssertionError(f"kernel disagrees at full size: {err}")
    worst = max(worst, err)

    times = {}
    for m in (1, 8, 100):
        rhs = torch.randn((g.n_pad, m), generator=gen, device=dev)
        rhs[g.n:] = 0.0
        kw = dict(want_missing=False, want_sq=False, p=P)
        reps = 20 if m == 1 else 5

        def kern():
            kernels.xt_dots_words(g.words, rhs, **kw)

        def plain():
            decode.xt_dots_words(g.words, rhs, **kw)

        # in turns: plain, kernel, kernel, plain
        pl = [cuda_ms(plain, 3)]
        kn = [cuda_ms(kern, reps), cuda_ms(kern, reps)]
        pl.append(cuda_ms(plain, 3))
        times[m] = (sum(kn) / 2, sum(pl) / 2)
        print(f"[kernel] {N} x {P} m={m}: kernel {times[m][0]:.3f} ms "
              f"(runs {kn[0]:.3f}, {kn[1]:.3f}), plain {times[m][1]:.3f} ms "
              f"(runs {pl[0]:.3f}, {pl[1]:.3f}) per X'R pass", flush=True)
    return g, causal, beta, worst, abs_err, times


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


def phase_main(g, causal, beta, card):
    y = phenotype(g, causal, beta, 7)
    out = []
    for run in ("cold", "warm"):
        kernels.LAUNCHES["xt_dots_words"] = 0
        t0 = time.perf_counter()
        r = fit_iht(y, g, k=K, verbose=False)
        wall = time.perf_counter() - t0
        launches = kernels.LAUNCHES["xt_dots_words"]
        sel = np.flatnonzero(r.beta)
        found = len(set(sel) & set(causal.tolist()))
        print(f"[main] {run} fit {N} x {P} k={K}: {wall:.3f} s on {card}; "
              f"iter {r.iter}, logl {r.logl}, causal recovered {found}/{K}, "
              f"{len(sel)} selected, kernel launches {launches}", flush=True)
        if len(sel) != K or found < 5 or launches < r.iter + 1:
            raise AssertionError("main path fit failed its checks")
        out.append(launches)
    return out[0]


def main():
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    g, causal, beta, worst, abs_err, times = phase_kernel(dev)
    phase_parity(dev)
    launches = phase_main(g, causal, beta, card)
    ms, plain_ms = times[1]
    print(json.dumps({"kernels": [dict(KERNEL, launches=launches,
                                       max_abs_err=abs_err, max_rel_err=worst,
                                       ms=ms, plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
