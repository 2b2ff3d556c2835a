"""A cell over several cards: one rank process a card, started by
``run.py``.

A configuration with a ``mesh`` (``{"task": T, "snp": S}``, T x S the
cell's ``chips``) runs as a world of T x S ranks on the port's (task, snp)
mesh.  ``run.py`` is then the launcher (``launch``): it starts ``chips``
rank processes of itself, rank r on card r, each told where the world
meets (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), relays
each rank's standard error with its rank in front, and ends every rank and
exits non-zero, rather than hang, when a rank dies or the world outlives
its deadline.  A rank (``Ranks``) joins the world through the port's
``multihost.init_process_group`` with a timeout on every collective,
builds the port's mesh, and holds the harness's own collectives: the
sums and broadcasts of the inputs, the lockstep of the closed loop, and
the gathers of the readings.  Those run on groups of ``torch.distributed``
made here, never through the port's mesh.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

# seconds a world may run past --seconds once its ranks have started:
# set-up, warm-up and the check (a run ends within 360 s, less the
# launcher's own start)
ALLOWANCE = 290.0
COLLECTIVE_TIMEOUT = 120.0     # s, every collective of the world's group


def free_port() -> int:
    """A free TCP port of this machine's loopback address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relay(stream, prefix: str, lock: threading.Lock, keep=None):
    """Copy ``stream``'s lines to ``keep`` (a list), or to standard error
    with ``prefix`` in front."""
    for line in stream:
        if keep is not None:
            keep.append(line)
            continue
        with lock:
            sys.stderr.write(prefix + line)
            sys.stderr.flush()


def launch(argv: list, chips: int, deadline_s: float, log=None):
    """Run ``chips`` ranks of ``argv`` (rank r with ``--rank r`` appended
    and ``RANK`` set), at most ``deadline_s`` seconds.  Returns (exit code,
    the last line rank 0 printed on standard output or None): 0 once every
    rank has exited 0; a rank's code as soon as one exits with another,
    124 at the deadline, every rank killed and waited for in both."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(chips))
    procs = [subprocess.Popen(argv + ["--rank", str(r)],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(chips)]
    lock, out0, threads = threading.Lock(), [], []
    for r, pr in enumerate(procs):
        for stream, keep in ((pr.stdout, out0 if r == 0 else None),
                             (pr.stderr, None)):
            threads.append(threading.Thread(
                target=_relay, args=(stream, f"[rank {r}] ", lock, keep),
                daemon=True))
    for t in threads:
        t.start()
    deadline = time.monotonic() + deadline_s
    try:
        while True:
            codes = [pr.poll() for pr in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                log(f"rank {bad[0][0]} exited {bad[0][1]}: ending the world")
                rc = bad[0][1]
                break
            if all(c == 0 for c in codes):
                rc = 0
                break
            if time.monotonic() > deadline:
                log(f"the world outlived its deadline of {deadline_s:.0f} s:"
                    f" ending it")
                rc = 124
                break
            time.sleep(0.05)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
        for pr in procs:
            pr.wait()
        for t in threads:
            t.join(timeout=10)
    lines = [s for s in out0 if s.strip()]
    return rc, (lines[-1].strip() if lines and rc == 0 else None)


def die_with(launcher_pid: int):
    """Have the kernel kill this process when its parent, the launcher,
    dies (Linux ``PR_SET_PDEATHSIG``); exit at once where it has already
    gone."""
    import ctypes
    import signal
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)           # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != launcher_pid:
        os._exit(1)


class Ranks:
    """This rank's place in the world of a sharded cell: the port's mesh
    of ``shape`` (``{"task": T, "snp": S}``) on ``device``, and the
    harness's collectives over the world (``from_first``, ``agree``,
    ``most``, ``gather``, ``first_object``) and over ``row``, the ranks
    of this rank's task row, which hold its tasks and split the SNPs
    (``snp_sum``).  Every rank makes the same calls in the same order."""

    def __init__(self, rank: int, shape: dict, device: torch.device,
                 timeout: float):
        from mendeliht_tpu_torch.parallel import multihost
        T, S = int(shape["task"]), int(shape["snp"])
        multihost.init_process_group(
            backend="nccl" if device.type == "cuda" else "gloo",
            timeout=timeout)
        self.mesh = multihost.make_global_mesh(n_task=T, n_snp=S,
                                               device=device)
        rows = [dist.new_group(list(range(t * S, (t + 1) * S)))
                for t in range(T)]
        self.row = rows[rank // S]
        self.size, self.device, self.first = T * S, device, rank == 0
        self.snp_shards, self.snp_coord = S, rank % S

    def shard(self, p: int):
        """(first SNP, SNPs a shard) of this rank's rows: the port's
        ``multihost.shard_rows``, whole quad rows, pad rows past p."""
        from mendeliht_tpu_torch.parallel import multihost
        p_pad, _ = multihost.shard_rows(p, self.snp_shards)
        per = p_pad // self.snp_shards
        return self.snp_coord * per, per

    def snp_sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.row)
        return t

    def from_first(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous().clone()
        dist.broadcast(t, src=0)
        return t

    def agree(self, failed: bool, done: bool):
        """(whether the call failed on any rank, whether rank 0's window
        has ended): one all-reduce after each call of the closed loop."""
        flags = torch.tensor([int(failed), int(done and self.first)],
                             device=self.device)
        dist.all_reduce(flags, op=dist.ReduceOp.MAX)
        failed, done = flags.tolist()
        return bool(failed), bool(done)

    def most(self, x: int) -> int:
        t = torch.tensor([int(x)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return int(t.item())

    def gather(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    def first_object(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def close(self):
        dist.destroy_process_group()
