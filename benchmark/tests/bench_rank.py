"""A rank of the CPU tests of sharded cells: ``run.main`` on a cell cut to
a tiny size, with what the test plants in it.

    python bench_rank.py SPEC.json <run.py's arguments, --rank r last>

``SPEC.json``: ``cell`` (a cell of BENCHMARK.json), ``config`` (keys that
replace the configuration's: the tiny sizes and the mesh), ``chips``,
``fault`` (None; ``"raise"``: a call of the window raises on rank
``fault_rank``, or on every rank where that is ``"all"``; ``"nan"``: that
call returns a non-finite answer; ``"exit"``: the rank exits in that call;
``"jax"``: a module named ``jax`` appears in the rank once the window has
closed) and ``dump`` (a directory: each rank writes its phenotypes, folds
and answers there).
"""

import json
import os
import pickle
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import data, run  # noqa: E402

FAULT_CALL = 1                   # the call of the window a fault hits


def plant(spec: dict, rank: int):
    load, drive = run.load_cell, run.drive

    def tiny(name):
        bench, cell, config, traffic = load(spec["cell"])
        return (bench, dict(cell, chips=spec["chips"]),
                dict(config, **spec["config"]), traffic)
    run.load_cell = tiny
    fault = (spec.get("fault") if spec.get("fault_rank") in (rank, "all")
             else None)
    if fault in ("raise", "nan", "exit"):
        call = run.Calls.__call__

        def faulty(self, i):
            if i != FAULT_CALL or not self.in_window:
                return call(self, i)
            if fault == "exit":
                os._exit(7)
            if fault == "raise":
                raise RuntimeError("a fault planted in this rank's call")
            ans = call(self, i)
            return {k: (v * float("nan") if k != "input" else v)
                    for k, v in ans.items()}
        run.Calls.__call__ = faulty
    if fault == "jax":
        check = run.check

        def check_with_jax(*args, **kwargs):
            sys.modules["jax"] = types.ModuleType("jax")
            return check(*args, **kwargs)
        run.check = check_with_jax

    def marked(calls, *args, **kwargs):
        calls.in_window = True
        out = drive(calls, *args, **kwargs)
        if spec.get("dump"):
            with open(Path(spec["dump"]) / f"answers{rank}.pkl", "wb") as f:
                pickle.dump(out[0], f)
        return out
    run.drive = marked
    run.Calls.in_window = False
    make = data.make_shard_problem

    def dumped(*args, **kwargs):
        pr = make(*args, **kwargs)
        if spec.get("dump"):
            with open(Path(spec["dump"]) / f"inputs{rank}.pkl", "wb") as f:
                pickle.dump(dict(ys=pr.ys, folds=pr.folds, lo=pr.lo,
                                 per=pr.per), f)
        return pr
    data.make_shard_problem = dumped


if __name__ == "__main__":
    argv = sys.argv[2:]
    plant(json.loads(Path(sys.argv[1]).read_text()),
          int(argv[argv.index("--rank") + 1]))
    sys.exit(run.main(argv))
