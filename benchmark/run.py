"""Run one cell of the benchmark of ``mendeliht_tpu_torch`` once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a configuration (``configs/<config>.json``: the genotype matrix,
its missing share, the family, link and precision, and the phenotype
model) under a traffic mix (``traffic/<traffic>.json``: the entry a user
calls, with its arguments, and the reference module that judges it), both
named in ``BENCHMARK.json``.  A run makes its inputs on the card from the
seed, warms up the cell's own call, then drives a closed loop for
``--seconds``: one caller who sends the next call when the last has
returned and the card is synchronised, cycling through the seed's
phenotypes in order.  After the window it checks a sample of the answers
against the plain reference (``reference/<name>.py``) and prints one JSON
line.  With ``--trace 1`` the window is a fixed number of calls under the
profiler instead, and the line holds the per-layer metrics
(``metrics/<name>.py``) and the breakdown.

The load comes from this one process with one host thread for torch,
OpenMP and the BLAS libraries (unless the environment sets them).

A cell whose configuration has a ``mesh`` (``{"task": T, "snp": S}``, T x
S its ``chips``) runs sharded over the SNP axis of the port's (task, snp)
mesh, one rank process a card (``benchmark/world.py``): this process
builds the port's kernels, starts the ranks, relays rank 0's line as its
own and exits non-zero if a rank does or the world outlives its deadline.
Each rank makes its own SNP rows on its card (``data.make_shard_problem``),
hands ``ShardedPackedOp(shard, mesh)`` to the traffic's entry, runs the
closed loop in lockstep with the others, and the reference is checked in
rank blocks (``reference/blocks.py``); rank 0 reports.
"""

import os
import time

T_START = time.perf_counter()
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mendeliht_tpu")


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix), each
    found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return bench, cell, config, traffic


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The entries of ``kind`` ("end_to_end" or "per_layer") this cell
    reports: those that list it, and those that list no cells but move
    (or are) an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]])
            and m["moves"] in names]


def reference_module(name: str):
    """``reference/<name>.py``: ``FAMILIES`` and ``ARGS``, the
    configurations and call arguments it follows; ``prepare(words, n, p,
    dtype)``; ``run(prepared, y, folds, args)``, its answer; ``answer``,
    what is compared of the program's result; ``compare(got, ref)``, the
    numbers that decide ``correct``."""
    import importlib
    return importlib.import_module(f"benchmark.reference.{name}")


def sharding(cell: dict, config: dict, traffic: dict):
    """The configuration's mesh, ``{"task": T, "snp": S}``, or None for a
    single-process cell.  Refused (ValueError) where ``chips`` is not T x S,
    where a cell of more than one chip has no mesh, and where the traffic's
    reference module cannot run in rank blocks."""
    from benchmark.reference import blocks
    chips, mesh = int(cell["chips"]), config.get("mesh")
    if mesh is None:
        if chips > 1:
            raise ValueError(f"{chips} chips and no mesh in the "
                             f"configuration {config['name']!r}")
        return None
    shape = {"task": int(mesh["task"]), "snp": int(mesh["snp"])}
    if shape["task"] * shape["snp"] != chips:
        raise ValueError(f"mesh {shape['task']} x {shape['snp']} of "
                         f"{config['name']!r} is not {chips} chips")
    if blocks.prepare_blocks(reference_module(traffic["reference"])) is None:
        raise ValueError(f"reference/{traffic['reference']}.py cannot run "
                         f"in rank blocks")
    return shape


def call_args(config: dict, traffic: dict) -> dict:
    """The traffic's call arguments, unchanged, after the configuration's
    family (``d``), link (``l``) and precision (``dtype``, unless the
    traffic gives its own).  Refused where the reference does not follow
    the configuration or an argument."""
    ref = reference_module(traffic["reference"])
    if (config["family"], config["link"]) not in ref.FAMILIES:
        raise ValueError(f"reference/{traffic['reference']}.py follows "
                         f"{ref.FAMILIES}, not ({config['family']}, "
                         f"{config['link']})")
    unknown = sorted(set(traffic["args"]) - set(ref.ARGS))
    if unknown:
        raise ValueError(f"reference/{traffic['reference']}.py does not "
                         f"follow the call arguments {unknown}")
    return {"dtype": config["dtype"], **traffic["args"]}


class Calls:
    """The traffic's entry into the port on the cell's inputs: call ``i``
    takes phenotype (and folds) ``i % inputs``, with the traffic's
    arguments, and returns what the reference module compares."""

    def __init__(self, traffic: dict, config: dict, g, problem):
        import mendeliht_tpu_torch as mt
        self.entry = getattr(mt, traffic["entry"])
        self.kw = dict(call_args(config, traffic),
                       d=getattr(mt, config["family"])(),
                       l=getattr(mt, config["link"])())
        self.answer = reference_module(traffic["reference"]).answer
        self.g, self.pr = g, problem

    def __call__(self, i: int):
        j = i % len(self.pr.ys)
        kw = self.kw
        if self.pr.folds:
            kw = dict(kw, folds=self.pr.folds[j])
        return dict(self.answer(self.entry(self.pr.ys[j], self.g, **kw)),
                    input=j)


def finite(ans) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(v, np.float64))))
               for v in ans.values())


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def drive(calls, n_calls, seconds, device, log, agree=None):
    """The closed loop: call after call until ``n_calls`` are done or
    ``seconds`` have passed at the end of one.  Returns (answers, None for
    a call that failed; each call's wall seconds; the window's seconds).
    In a world of ranks, ``agree(failed, last)`` after each call, outside
    its wall, gives (whether it failed on any rank, whether rank 0's window
    has ended), so that every rank makes the same calls."""
    from benchmark.trace import CALL
    answers, walls = [], []
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        c0 = time.perf_counter()
        try:
            with torch.profiler.record_function(CALL):
                ans = calls(i)
            sync(device)
            if not finite(ans):
                log(f"call {i}: non-finite answer")
                ans = None
        except Exception as exc:          # a failed call counts as failed
            log(f"call {i} failed: {type(exc).__name__}: {exc}")
            ans = None
        end = time.perf_counter()
        walls.append(end - c0)
        i += 1
        last = i >= n_calls or end - t0 >= seconds
        if agree is not None:
            failed, last = agree(ans is None, last)
            ans = None if failed else ans
        answers.append(ans)
        if last:
            return answers, walls, end - t0


def checked_calls(answers, walls, traffic, seed):
    """The calls whose answers are compared: the longest one, then calls
    drawn from the seed, each of another input,
    ``traffic["check_calls"]`` in all."""
    rng = np.random.default_rng([int(seed), 2])
    done = [i for i, a in enumerate(answers) if a is not None]
    order = [max(done, key=lambda i: walls[i])] if done else []
    order += [int(i) for i in rng.permutation(done)]
    out, seen = [], set()
    for i in order:
        if answers[i]["input"] not in seen:
            seen.add(answers[i]["input"])
            out.append(i)
        if len(out) == traffic["check_calls"]:
            break
    return out


def check(answers, picks, config, traffic, problem, log=print, ranks=None):
    """Compare the picked answers with the plain reference in float64:
    {number: worst reading over the picks}.  In a world of ranks every
    rank runs the reference on its own rows (``reference/blocks.py``)."""
    ref = reference_module(traffic["reference"])
    args = call_args(config, traffic)
    if ranks is None:
        G = ref.prepare(problem.words, problem.n, problem.p, torch.float64)
    else:
        from benchmark.reference import blocks
        G = blocks.prepare_blocks(ref)(problem.words, problem.n, problem.p,
                                       problem.lo, ranks.row, torch.float64)
    worst = {}
    for i in picks:
        a = answers[i]
        j = a["input"]
        t0 = time.perf_counter()
        folds = problem.folds[j] if problem.folds else None
        got = ref.compare(a, ref.run(G, problem.ys[j], folds, args))
        log(f"checked call {i} (input {j}) in {time.perf_counter() - t0:.1f}"
            f" s: " + ", ".join(f"{k} {v!r}" for k, v in got.items()))
        for k, v in got.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def make_genotypes(problem, config: dict, traffic: dict, p=None):
    """The port's genotypes on the card, from the benchmark's words and
    its float64 statistics cast to the call's precision; ``p`` the SNPs
    the words hold where they are a shard's."""
    from mendeliht_tpu_torch import PackedGenotypes
    dtype = getattr(torch, call_args(config, traffic)["dtype"])
    kw = dict(dtype=dtype, device=problem.words.device)
    return PackedGenotypes(words=problem.words,
                           mu=torch.as_tensor(problem.mu, **kw),
                           inv_sd=torch.as_tensor(problem.inv_sd, **kw),
                           n=problem.n, p=problem.p if p is None else p,
                           has_missing=problem.has_missing,
                           n_missing=problem.n_missing)


def run_cell(bench, cell, config, traffic, seed: int, seconds: float,
             trace: bool, device, t_start: float, log=None,
             ranks=None) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields.  With
    ``ranks`` (``world.Ranks``), this rank's part of a sharded run; rank
    0's fields are the run's."""
    from benchmark import data
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    call_args(config, traffic)          # refuse what the reference cannot
    t0 = time.perf_counter()
    if ranks is None:
        problem = data.make_problem(config, traffic, seed, device)
        g = make_genotypes(problem, config, traffic)
    else:
        lo, per = ranks.shard(int(config["p"]))
        from mendeliht_tpu_torch.parallel import ShardedPackedOp
        problem = data.make_shard_problem(config, traffic, seed, device, lo,
                                          per, ranks)
        g = ShardedPackedOp(make_genotypes(problem, config, traffic, per),
                            ranks.mesh)
    sync(device)
    t1 = time.perf_counter()
    calls = Calls(traffic, config, g, problem)
    for i in range(traffic["warm_calls"]):
        calls(i)
    sync(device)
    if ranks is not None:
        ranks.agree(False, False)       # the window opens on every rank
    log(f"set-up: {t0 - t_start:.2f} s to start, inputs {t1 - t0:.2f} s, "
        f"warm-up {time.perf_counter() - t1:.2f} s")
    gc.collect()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s; window of "
        + (f"{traffic['trace_calls']} traced calls" if trace
           else f"{seconds} s"))
    agree = ranks.agree if ranks is not None else None
    if trace:
        from benchmark import trace as tr, workcount
        (answers, walls, window_s), events, wall, widths = tr.profile(
            lambda: drive(calls, traffic["trace_calls"], math.inf, device,
                          log, agree), device)
        summary = {}
        if ranks is None or ranks.first:
            peak = (workcount.peaks(torch.cuda.get_device_name(device))
                    if cuda else None)
            summary = tr.summarize(events, wall, widths, peak)
        if ranks is not None:
            summary["ranks"] = ranks.gather(tr.rank_reading(events, wall))
        # a reader may take anything of the trace: the profiler's events
        # and each score's (n, p, m) ride along
        summary.update(kind=traffic["kind"], events=events, widths=widths)
    else:
        answers, walls, window_s = drive(calls, math.inf, seconds, device,
                                         log, agree)
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    if ranks is not None:
        peak_bytes = ranks.most(peak_bytes)    # the fullest card's
    done = sum(a is not None for a in answers)
    log(f"window {window_s:.3f} s: {len(answers)} calls, {done} answered; "
        f"call walls median {np.median(walls):.4f} s, longest "
        + ", ".join(f"{walls[i]:.4f} s (call {i})"
                    for i in np.argsort(walls)[::-1][:3]))
    log("walls " + json.dumps([float(f"{w:.6g}") for w in walls]))

    g.words_t = None                # the port's dual layout, if it built one
    del g, calls
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picks = checked_calls(answers, walls, traffic, seed)
    if ranks is not None:
        picks = ranks.first_object(picks)     # by rank 0's walls
    numbers = check(answers, picks, config, traffic, problem, log=log,
                    ranks=ranks)
    if ranks is not None and not ranks.first:
        return None                     # rank 0 reports
    limits = traffic["limits"]
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    failed = len(answers) - done
    correct = (failed == 0 and len(picks) > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    if trace:
        for m in cell_metrics(bench, cell, "per_layer"):
            v = metric_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(
            setup_s=setup_s,
            peak_gib=peak_bytes / 2**30,
            cv_s=window_s / done if done else math.inf,
            fit_s=window_s / done if done else math.inf,
            fit_p95_s=float(np.percentile(walls, 95)) if walls else math.inf)
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak_bytes)}
    out = {"correct": bool(correct), "attempted": len(answers),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["wall_s"]
        out["breakdown"] = summary["breakdown"]
        log("trace: " + json.dumps({k: v for k, v in summary.items()
                                    if k not in ("breakdown", "events",
                                                 "widths")}))
    out["checks"] = checks
    return out


def jax_loaded() -> bool:
    """Whether a module of JAX or the JAX package is loaded in this
    process, named on standard error where one is."""
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
    return bool(bad)


def report(out: dict) -> int:
    """Print the result line, the numbers compared beside their limits last
    on standard error; refused (3, no line) where a module of JAX or the
    JAX package is loaded in this process."""
    if jax_loaded():
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def launch_cell(args, chips: int, device_type: str = "cuda",
                program=None, t_start: float = T_START,
                allowance: float | None = None,
                collective_timeout: float | None = None) -> int:
    """The launcher of a sharded cell: builds the port's kernels once, then
    runs ``chips`` ranks of ``program`` (this file by default) on
    ``device_type``, and reports rank 0's line as its own.  ``setup_s``
    counts from ``t_start``, this process's start."""
    from benchmark import world
    if device_type == "cuda":           # before the ranks, who would race
        from mendeliht_tpu_torch.ops import kernels
        kernels.build_library("xt_dots_t")
    program = program or [sys.executable, str(Path(__file__).resolve())]
    launched_at = time.monotonic() - (time.perf_counter() - t_start)
    argv = [*program, "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace),
            "--device", device_type, "--launched-at", repr(launched_at),
            "--launcher-pid", str(os.getpid()), "--collective-timeout",
            repr(collective_timeout or world.COLLECTIVE_TIMEOUT)]
    rc, line = world.launch(argv, chips, args.seconds
                            + (allowance or world.ALLOWANCE))
    if rc == 0 and line is None:
        print("rank 0 printed no result", file=sys.stderr)
        return 1
    return rc or report(json.loads(line))


def rank_main(args, bench, cell, config, traffic, shape) -> int:
    """One rank of a sharded cell, started by ``launch_cell``."""
    from benchmark import world
    world.die_with(args.launcher_pid)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    t_start = time.perf_counter() - (time.monotonic() - args.launched_at)
    ranks = world.Ranks(args.rank, shape, device, args.collective_timeout)
    out = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                   bool(args.trace), device, t_start, ranks=ranks)
    rc = report(out) if ranks.first else 3 if jax_loaded() else 0
    ranks.close()
    return rc


def main(argv=None) -> int:
    t_imports = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a sharded cell: what the launcher tells it
    for flag, kind in (("--rank", int), ("--device", str),
                       ("--launched-at", float), ("--launcher-pid", int),
                       ("--collective-timeout", float)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    try:
        shape = sharding(cell, config, traffic)
    except ValueError as exc:
        print(f"{args.workload} refused: {exc}", file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args, bench, cell, config, traffic, shape)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    if shape is not None:
        return launch_cell(args, int(cell["chips"]))
    device = torch.device("cuda", 0)
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    torch.cuda.init()
    print(f"imports {t_imports - T_START:.2f} s, CUDA start "
          f"{time.perf_counter() - t_imports:.2f} s", file=sys.stderr)
    out = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                   bool(args.trace), device, T_START)
    return report(out)


if __name__ == "__main__":
    sys.exit(main())
