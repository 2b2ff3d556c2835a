"""Readings that the limits of ``correct`` are set from: for each seed, the
program's answers to the cell's first inputs and the control's, each
compared with the float64 reference by the traffic's reference module.

The control is the reference put in the program's place and computed in
the precision below the call's (``LOWER``: bfloat16 below float32, float32
below float64).  It has to read above the limits on every seed; the
program below them.

    python3 benchmark/control.py --workload <name> --seeds <n> ... \
        [--inputs <k>]

prints one JSON line a seed and side to standard output.  The benchmark's
runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import data, run  # noqa: E402

LOWER = {"float32": torch.bfloat16, "float64": torch.float32}


def readings(config, traffic, seed, inputs, device, sides=("program",
                                                           "control")):
    """{side: {number: worst over the inputs}} for one seed."""
    problem = data.make_problem(config, traffic, seed, device)
    ref = run.reference_module(traffic["reference"])
    args = run.call_args(config, traffic)

    def answers(G):
        return [ref.run(G, problem.ys[j],
                        problem.folds[j] if problem.folds else None, args)
                for j in range(inputs)]
    got = {}
    if "program" in sides:
        g = run.make_genotypes(problem, config, traffic)
        calls = run.Calls(traffic, config, g, problem)
        got["program"] = [calls(j) for j in range(inputs)]
        g.words_t = None
        del g, calls
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if "control" in sides:
        low = ref.prepare(problem.words, problem.n, problem.p,
                          LOWER[args["dtype"]])
        got["control"] = answers(low)
        del low
    G = ref.prepare(problem.words, problem.n, problem.p, torch.float64)
    out = {side: {} for side in got}
    for j, want in enumerate(answers(G)):
        for side, a in got.items():
            for k, v in ref.compare(a[j], want).items():
                out[side][k] = max(out[side].get(k, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--inputs", type=int, default=None)
    ap.add_argument("--sides", nargs="+", default=["program", "control"])
    args = ap.parse_args(argv)
    _, cell, config, traffic = run.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    inputs = args.inputs or traffic["check_calls"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(config, traffic, seed, inputs,
                       torch.device("cuda", 0), tuple(args.sides))
        for side, nums in out.items():
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  side=side, seconds=time.perf_counter() - t0,
                                  **nums)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
