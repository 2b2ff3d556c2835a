"""Rank process of the port's multi-process suites, and the launcher the
suites call (``World``; the twin of tests/multihost_worker.py).

    python tests/torch_multihost_worker.py INIT_FILE RANK WORLD SUITE IN OUT

Each rank joins a gloo world through ``INIT_FILE`` (a ``file://`` init, a
timeout on every collective), runs on the CPU with one torch thread, reads
the inputs the test wrote to ``IN`` (.npz), runs the cases of ``SUITE``
("parallel", "parallel_mv" or "multihost") and writes its results to
``OUT`` (.npz, keys ``case/field``).  Results of the sharded solver are
gathered whole on every rank, so the test can also check that the ranks
agree.  This file imports nothing of JAX: the tests hold its results to
the JAX package in their own process.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
COLLECTIVE_TIMEOUT = 120        # s, every collective of a world
WORLD_TIMEOUT = 300             # s, a whole world, start-up included


class World:
    """``world`` rank processes of ``suite`` on ``inputs``, started at
    once; :meth:`results` waits for them."""

    def __init__(self, suite: str, world: int, inputs: dict, tmp_path,
                 timeout: float = WORLD_TIMEOUT):
        tmp = str(tmp_path)
        case_file = os.path.join(tmp, f"{suite}_in.npz")
        np.savez(case_file, **inputs)
        init = os.path.join(tmp, f"{suite}_init")
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(HERE), env.get("PYTHONPATH", "")])
        self.suite, self.timeout = suite, timeout
        self.outs = [os.path.join(tmp, f"{suite}_out{r}.npz")
                     for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), init, str(r),
             str(world), suite, case_file, self.outs[r]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def results(self) -> list[dict]:
        """Each rank's results; every rank killed, and AssertionError
        raised, when they do not all end within the timeout or one
        fails."""
        logs = []
        try:
            for pr in self.procs:
                logs.append(pr.communicate(timeout=max(
                    1.0, self.deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(
                f"{self.suite}: the world of {len(self.procs)} ranks did "
                f"not end within {self.timeout} s") from None
        finally:
            for pr in self.procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        for r, (pr, log) in enumerate(zip(self.procs, logs)):
            if pr.returncode != 0:
                raise AssertionError(f"{self.suite}: rank {r} exited "
                                     f"{pr.returncode}:\n{log[-4000:]}")
        results = []
        for out in self.outs:
            with np.load(out) as f:
                results.append({k: f[k] for k in f.files})
        return results


# -- rank side -------------------------------------------------------------

def _geno(codes, sample_major=True):
    import mendeliht_tpu_torch as mt
    return mt.PackedGenotypes.from_codes(codes, sample_major, device="cpu")


def _state(cls, inp, prefix):
    """The state ``cls`` from the fields the test saved as ``prefix/...``
    (the JAX package's initial state)."""
    arrays = {k[len(prefix) + 1:]: v for k, v in inp.items()
              if k.startswith(prefix + "/")}
    return cls.from_numpy(arrays, "cpu")


def _whole(st, mesh):
    from mendeliht_tpu_torch.parallel import gather_state
    st = gather_state(st, mesh)
    return {f.name: np.asarray(getattr(st, f.name)) for f in
            dataclasses.fields(st) if f.name != "iteration"}


def _solve(x, y, k, mesh, inp, case, tag=None, max_iter=25, **kw):
    """The sharded solve of a batch of fits of (x, y) at k from the JAX
    package's initial state saved as ``case/st0``, and the port's own
    initial state on the sharded operator, as ``tag/...`` and
    ``tag/init/...`` (``tag`` default ``case``)."""
    from mendeliht_tpu_torch.models.fit import build_fit
    from mendeliht_tpu_torch.models.initialize import init_state
    from mendeliht_tpu_torch.models.state import IHTState
    from mendeliht_tpu_torch.models.univariate import run_iht
    from mendeliht_tpu_torch.ops.linalg import PackedOp
    from mendeliht_tpu_torch.parallel import shard_geno_op, shard_state

    op = shard_geno_op(PackedOp(x), mesh)
    op, data, cfg, _ = build_fit(y, op, None, k=k, max_iter=max_iter, **kw)
    st0 = _state(IHTState, inp, f"{case}/st0")
    tag = tag or case
    out = {f"{tag}/{name}": v for name, v in _whole(
        run_iht(op, data, cfg, shard_state(st0, mesh)), mesh).items()}
    init = init_state(op, data, cfg, st0.k, st0.cv_wts)
    out.update({f"{tag}/init/{name}": v
                for name, v in _whole(init, mesh).items()})
    return out


def _meshes(inp):
    return [tuple(int(v) for v in m) for m in inp["meshes"]]


def suite_parallel(inp, rank):
    import torch

    import mendeliht_tpu_torch as mt
    from mendeliht_tpu_torch.models.fit import build_fit
    from mendeliht_tpu_torch.models.state import IHTState
    from mendeliht_tpu_torch.models.univariate import _iteration
    from mendeliht_tpu_torch.ops.linalg import PackedOp
    from mendeliht_tpu_torch.parallel import (dryrun_multichip, make_mesh,
                                              pad_geno_rows, shard_data,
                                              shard_geno_op, shard_state)

    out = {}
    x = _geno(inp["main/codes"])
    y, k = inp["main/y"], int(inp["main/k"])
    op, data, cfg, _ = build_fit(y, x, None, k=k, max_iter=30)
    st0 = _state(IHTState, inp, "main/st0")
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    R, W, WY = f32(inp["ops/R"]), f32(inp["ops/W"]), f32(inp["ops/WY"])
    idx = torch.from_numpy(inp["ops/idx"])
    coef, valid = f32(inp["ops/coef"]), f32(inp["ops/valid"])
    for nt, ns in _meshes(inp):
        tag = f"{nt}x{ns}"
        mesh = make_mesh(nt, ns, device="cpu")
        op_s = shard_geno_op(op, mesh)
        st = _iteration(op_s, shard_data(data, mesh), cfg,
                        shard_state(st0, mesh))
        for name, v in _whole(st, mesh).items():
            out[f"iter_{tag}/{name}"] = v
        out.update(_solve(x, y, k, mesh, inp, "main", f"solve_{tag}",
                          max_iter=30))
        # the operator: every task's rows whole on every rank
        rows = lambda a: op_s.task_rows(a)  # noqa: E731
        tasks = lambda a: op_s.gather_tasks(a)  # noqa: E731
        out[f"ops_{tag}/xtr"] = tasks(op_s.gather_snps(op_s.xtr(rows(R))))
        out[f"ops_{tag}/forward_sel"] = tasks(op_s.forward_sel(
            rows(idx), rows(coef), rows(valid)))
        for name, v in zip(("Sx", "Sxx", "Sxy"),
                           op_s.col_moments(rows(W), rows(WY))):
            out[f"ops_{tag}/{name}"] = tasks(op_s.gather_snps(v))
        out[f"ops_{tag}/gather_cols"] = tasks(op_s.gather_cols(
            rows(idx), rows(valid)))

    mesh14, mesh22 = make_mesh(1, 4, device="cpu"), make_mesh(2, 2,
                                                              device="cpu")
    out["mesh/ranks"] = mesh22.ranks
    out["mesh/coords"] = [mesh22.coords["task"], mesh22.coords["snp"]]
    try:
        make_mesh(16, 16, device="cpu")
        out["mesh/error"] = ""
    except ValueError as e:
        out["mesh/error"] = str(e)
    for case, mesh in (("ragged", mesh14), ("exceed", mesh14),
                       ("one_shard", mesh22)):
        xc = _geno(inp[f"{case}/codes"])
        if case != "one_shard":
            xc = pad_geno_rows(xc, 4)
        out.update(_solve(xc, inp[f"{case}/y"], int(inp[f"{case}/k"]), mesh,
                          inp, case))
    for case, mesh in (("group_scalar", mesh22), ("group_vector", mesh22),
                       ("group_span", mesh14)):
        # (group_scalar: the 2 x 2 mesh; the 1 x 4 one below)
        kk = inp[f"{case}/k"]
        out.update(_solve(_geno(inp[f"{case}/codes"]), inp[f"{case}/y"],
                          kk.tolist() if kk.ndim else int(kk), mesh, inp,
                          case, J=2, group=inp[f"{case}/group"]))
    out.update(_solve(_geno(inp["group_scalar/codes"]),
                      inp["group_scalar/y"], int(inp["group_scalar/k"]),
                      mesh14, inp, "group_scalar", "group_scalar_1x4", J=2,
                      group=inp["group_scalar/group"]))

    # the entry points take the sharded operator as they take a PackedOp
    r = mt.fit_iht(y, shard_geno_op(PackedOp(x), mesh14), k=k, max_iter=30,
                   verbose=False)
    out.update({"fit_entry/beta": r.beta, "fit_entry/c": r.c,
                "fit_entry/logl": r.logl, "fit_entry/iter": r.iter})
    out["cv_entry/mse"] = mt.cv_iht(
        y, shard_geno_op(PackedOp(x), mesh22), path=list(inp["cv/path"]),
        q=int(inp["cv/q"]), folds=inp["cv/folds"], verbose=False)

    dry = dryrun_multichip(4, device="cpu")
    out["dryrun/logl"] = np.asarray(dry["logl"])
    out["dryrun/mv_logl"] = np.asarray(dry["mv_logl"])
    return out


def _solve_mv(op, data, cfg, mesh, inp, case):
    """The sharded mv solve from the JAX package's initial state saved as
    ``case/st0``, and the port's own initial state on the sharded
    operator (``case/init``)."""
    from mendeliht_tpu_torch.models.mv import (MIHTState, init_mv_state,
                                               run_mv_iht)
    from mendeliht_tpu_torch.parallel import shard_mv_state

    st0 = _state(MIHTState, inp, f"{case}/st0")
    out = {f"{case}/{name}": v for name, v in _whole(
        run_mv_iht(op, data, cfg, shard_mv_state(st0, mesh)), mesh).items()}
    init = init_mv_state(op, data, cfg, st0.k, st0.cv_wts)
    out.update({f"{case}/init/{name}": v
                for name, v in _whole(init, mesh).items()})
    return out


def suite_parallel_mv(inp, rank):
    import torch

    import mendeliht_tpu_torch as mt
    from mendeliht_tpu_torch.models.mv import (MIHTState, _iteration_mv,
                                               build_mv, cv_mv)
    from mendeliht_tpu_torch.ops.linalg import PackedOp
    from mendeliht_tpu_torch.parallel import (make_mesh, pad_geno_rows,
                                              shard_geno_op, shard_mv_data,
                                              shard_mv_state)

    out = {}
    x = _geno(inp["main/codes"])
    Y = inp["main/Y"]
    op, data, cfg = build_mv(Y, x, k=6, max_iter=25)
    st0 = _state(MIHTState, inp, "main/st0")
    meshes = {m: make_mesh(*m, device="cpu") for m in _meshes(inp)}
    for (nt, ns), mesh in meshes.items():
        st = _iteration_mv(shard_geno_op(op, mesh), shard_mv_data(data, mesh),
                           cfg, shard_mv_state(st0, mesh))
        for name, v in _whole(st, mesh).items():
            out[f"iter_{nt}x{ns}/{name}"] = v

    mesh22, mesh14 = meshes[(2, 2)], meshes[(1, 4)]
    op_s = shard_geno_op(op, mesh22)
    out.update(_solve_mv(op_s, data, cfg, mesh22, inp, "main"))

    xr = pad_geno_rows(_geno(inp["ragged/codes"]), 4)
    opr, datar, cfgr = build_mv(inp["ragged/Y"], shard_geno_op(
        PackedOp(xr), mesh14), k=int(inp["ragged/k"]), max_iter=20)
    out.update(_solve_mv(opr, datar, cfgr, mesh14, inp, "ragged"))

    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa
    out["cv/mse"] = cv_mv(op_s, data, cfg, torch.from_numpy(inp["cv/ks"]),
                          f32(inp["cv/train"]), f32(inp["cv/test"]))
    r = mt.fit_iht(Y, shard_geno_op(PackedOp(x), mesh14), k=6, max_iter=25,
                   verbose=False)
    out.update({"fit_entry/beta": r.beta, "fit_entry/c": r.c,
                "fit_entry/logl": r.logl, "fit_entry/iter": r.iter,
                "fit_entry/Sigma": r.Sigma})
    return out


def suite_multihost(inp, rank):
    import datetime

    import torch
    import torch.distributed as dist

    from mendeliht_tpu_torch import fit_iht
    from mendeliht_tpu_torch.parallel import ShardedPackedOp
    from mendeliht_tpu_torch.parallel import multihost as mh

    prefix = str(inp["prefix"])
    mesh = mh.make_global_mesh(n_task=1, n_snp=2, device="cpu")
    geno, p_true = mh.load_bed_shard(prefix, mesh)
    y = np.loadtxt(prefix + ".phen")
    r = fit_iht(y, ShardedPackedOp(geno, mesh), k=int(inp["k"]), max_iter=50,
                verbose=False)
    b = r.beta[:p_true]
    out = {"fit/support": np.flatnonzero(b), "fit/beta": b[b != 0],
           "fit/c": r.c, "fit/logl": r.logl, "fit/iter": r.iter,
           "fit/p_true": p_true, "fit/has_missing": geno.has_missing,
           "shard/words": geno.words, "shard/mu": geno.mu,
           "shard/inv_sd": geno.inv_sd}

    # missing calls in the second shard alone: every rank says so
    out["missing/has_missing"] = mh.load_bed_shard(
        str(inp["missing_prefix"]), mesh)[0].has_missing

    # a rank that leaves the others' collective: they fail at the
    # group's timeout, never hang
    group = dist.new_group([0, 1], timeout=datetime.timedelta(
        seconds=float(inp["desync_timeout"])))
    timeout = float(inp["desync_timeout"])
    t0 = time.monotonic()
    err = ""
    if rank == 0:
        try:
            dist.all_reduce(torch.ones(1), group=group)
        except RuntimeError as e:
            err = type(e).__name__ + ": " + str(e)[:200]
    else:
        time.sleep(2.5 * timeout)      # alive, outside the collective
    out["desync/seconds"] = time.monotonic() - t0
    out["desync/error"] = err
    return out


SUITES = {"parallel": suite_parallel, "parallel_mv": suite_parallel_mv,
          "multihost": suite_multihost}


def main(argv):
    init, rank, world, suite, case_file, out_file = argv
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    from mendeliht_tpu_torch.parallel import multihost as mh
    mh.init_process_group("file://" + init, world_size=world, rank=rank,
                          backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    with np.load(case_file) as f:
        inp = {k: f[k] for k in f.files}
    out = SUITES[suite](inp, rank)
    out = {k: (v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v))
           for k, v in out.items()}
    np.savez(out_file, **out)
    if suite != "multihost":
        import torch.distributed as dist
        dist.destroy_process_group()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1:])
