"""The single-task fit's host-stepped iteration, replayed as CUDA graphs.

``univariate._iteration`` launches a few hundred small kernels an
iteration from Python; for one task on the card they are microseconds
each, so such a fit waits on the host most of its time.  Here the
iteration's launches between its host reads are captured once as three
CUDA graphs over static buffers and replayed in every later iteration and
fit of the same shapes:

- ``step``: ``univariate._step`` (save_prev, the step size, the first
  step and the first backtracking test);
- ``backtrack``: ``univariate._backtrack`` (one step at half eta and the
  next test);
- ``post``: ``univariate._post_step`` (the score, the NaN guard and the
  convergence test), the iteration count kept on the card.

The host reads ``need.any()`` after ``step`` and each ``backtrack`` and
``active.any()`` before each iteration, as the eager loop does
(:func:`advance` is ``univariate.run_segment`` over the static state).  The
math stays in ``univariate``'s functions: each piece calls them on the
static state and copies its results back into it, so a replayed fit
equals the eager one bit for bit.  The pieces also run eagerly, without a
graph, on any device (:attr:`Loop.pieces`).

Only a solve that reads nothing on the host between those reads and runs
on one card replays (:func:`engaged`); every other solve runs
``univariate.run_segmented``.  The graphs of one key live on the
genotypes (``PackedGenotypes.replay_loop``): the key (:func:`key`) holds
everything the captured launches read by address or bake in, computed
from the live tensors at every solve, so a graph only ever reads tensors
alive at the addresses it captured.  Another key replaces the entry and
frees its graphs.  One replayed solve runs at a time in a process
(``_LOCK``): solves in several threads would share the static buffers.

Spans: ``iht.capture`` around the first solve's capture, ``iht.replay``
around each replay, inside the loop's ``iht.iteration``, ``iht.backtrack``
and ``iht.sync``.  ``ops.kernels.LAUNCHES`` counts a replay's score
launches as the eager loop would: a capture counts none, each replay adds
its graph's.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ..ops import kernels
from ..ops.linalg import PackedOp, transposed_score
from ..utils.profiling import span
from . import univariate
from .state import FitConfig, FitData, IHTState

_FIELDS = [f.name for f in dataclasses.fields(IHTState)
           if f.name != "iteration"]
_DATA = ("y", "z", "zkeep", "sample_mask", "weight", "group", "group_ks")
# the keys of univariate._take_step's step
_STEP = ("b", "c", "sel_idx", "sel_valid", "idc", "xb", "zc", "mu", "nb_r",
         "logl")
_LOCK = threading.Lock()


def engaged(op, cfg: FitConfig, B: int, segments: dict) -> bool:
    """Whether the solve of ``B`` tasks on ``op`` replays: a single-device
    PackedOp on the card, one task, an iteration that reads nothing on the
    host (no per-iteration lines, no debias, no negative-binomial r
    update) and one segment (no checkpoints, no progress lines)."""
    return (type(op) is PackedOp and op.device.type == "cuda" and B == 1
            and not cfg.log_iters and not cfg.debias
            and cfg.est_r == "none"
            and segments.get("checkpoint_dir") is None
            and not segments.get("progress"))


def key(op: PackedOp, data: FitData, cfg: FitConfig, st: IHTState) -> tuple:
    """What the captured launches read by address or bake in: the
    configuration and shapes, the score's route, and the addresses of the
    words, the operator's statistics and the score's cached row map."""
    g = op.geno
    B = st.active.shape[0]
    row_map = kernels.score_row_map(B, 1 + bool(g.has_missing),
                                    op.dtype == torch.float64, op.device)
    return (cfg, B, data.z.shape[1], op.n_pad, data.n_true, op.dtype,
            str(op.device), transposed_score(g, B),
            tuple(0 if t is None else t.data_ptr()
                  for t in (g.words, g.words_t, op.mu, op.inv_sd, row_map)))


class Loop:
    """Static buffers of one solve's data and state, the three pieces of
    the iteration over them, and their graphs once captured."""

    def __init__(self, k: tuple, data: FitData, st: IHTState):
        self.key = k
        self.data = dataclasses.replace(data, **{
            f: torch.empty_like(getattr(data, f)) for f in _DATA
            if getattr(data, f) is not None})
        self.st = dataclasses.replace(st, **{
            f: torch.empty_like(getattr(st, f)) for f in _FIELDS})
        self.eta = torch.empty_like(st.eta)
        self.n_bt = torch.empty_like(st.backtracks)
        self.need = torch.empty_like(st.active)
        self.it = torch.zeros((), dtype=torch.int64, device=st.k.device)
        self.cur = {f: torch.empty_like(getattr(st, f)) for f in _STEP}
        self.graphs = None
        self.launches = None

    @property
    def pieces(self):
        """The iteration's three pieces, each ``piece(op, cfg)``: step,
        backtrack, post."""
        return (self.step, self.backtrack, self.post)

    def load(self, data: FitData, st: IHTState):
        """Copy a solve's data and initial state into the buffers."""
        for f in _DATA:
            dst = getattr(self.data, f)
            if dst is not None:
                dst.copy_(getattr(data, f))
        self._keep_state(st)
        self.it.fill_(st.iteration)

    def result(self, iteration: int) -> IHTState:
        """The state the buffers hold, as tensors of its own."""
        return dataclasses.replace(self.st, iteration=iteration, **{
            f: getattr(self.st, f).clone() for f in _FIELDS})

    def _keep_state(self, st: IHTState):
        for f in _FIELDS:
            src, dst = getattr(st, f), getattr(self.st, f)
            if src is not dst:
                dst.copy_(src)

    def _keep_step(self, eta, cur, n_bt, need):
        self.eta.copy_(eta)
        for f in _STEP:
            self.cur[f].copy_(cur[f])
        self.n_bt.copy_(n_bt)
        self.need.copy_(need)

    def step(self, op, cfg: FitConfig):
        st, eta, cur, n_bt, need = univariate._step(op, self.data, cfg,
                                                    self.st)
        self._keep_state(st)
        self._keep_step(eta, cur, n_bt, need)

    def backtrack(self, op, cfg: FitConfig):
        self._keep_step(*univariate._backtrack(
            op, self.data, cfg, self.st, self.eta, self.cur, self.n_bt,
            self.need))

    def post(self, op, cfg: FitConfig):
        it = self.it + 1
        self._keep_state(univariate._post_step(
            op, self.data, cfg, self.st, self.cur, self.eta, self.n_bt,
            it=it))
        self.it.copy_(it)

    def capture(self, op, cfg: FitConfig):
        """Capture the three pieces as CUDA graphs in one memory pool, on a
        side stream; nothing runs.  The score launches each capture
        counted in ``kernels.LAUNCHES`` are taken back and kept, for its
        replays to add."""
        device = self.it.device
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        graphs, launches = [], []
        for piece in self.pieces:
            before = dict(kernels.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    piece(op, cfg)
                finally:
                    graph.capture_end()
            counted = [(n, kernels.LAUNCHES[n] - c) for n, c in before.items()
                       if kernels.LAUNCHES[n] != c]
            for n, c in counted:
                kernels.LAUNCHES[n] -= c
            graphs.append(graph)
            launches.append(counted)
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graphs, self.launches = graphs, launches

    def replay(self, i: int, op, cfg: FitConfig):
        """Run piece ``i`` (0 step, 1 backtrack, 2 post) from its graph,
        capturing the three first where they are not yet."""
        if self.graphs is None:
            with span("iht.capture"):
                self.capture(op, cfg)
        with span("iht.replay"):
            self.graphs[i].replay()
        for n, c in self.launches[i]:
            kernels.LAUNCHES[n] += c


def advance(loop: Loop, cfg: FitConfig, iteration: int, stop: int,
            run) -> int:
    """``univariate.run_segment``'s loop over ``loop``'s state from
    ``iteration``, with ``run(i)`` running piece i; returns the iteration
    reached."""
    limit = min(int(stop), cfg.max_iter - 1)
    while iteration < limit and univariate._any(loop.st.active):
        with span("iht.iteration"):
            run(0)
            while univariate._any(loop.need):
                with span("iht.backtrack"):
                    run(1)
            run(2)
        iteration += 1
    return iteration


def entry(op: PackedOp, data: FitData, cfg: FitConfig,
          st: IHTState) -> Loop:
    """The genotypes' Loop for this solve's key: the one they hold, or a
    new one in its place."""
    g, k = op.geno, key(op, data, cfg, st)
    if g.replay_loop is None or g.replay_loop.key != k:
        g.replay_loop = None            # free the old graphs first
        g.replay_loop = Loop(k, data, st)
    return g.replay_loop


def solve(op: PackedOp, data: FitData, cfg: FitConfig,
          st: IHTState) -> IHTState:
    """``univariate.run_segmented``'s solve of an :func:`engaged` fit,
    replayed from the genotypes' graphs of its key."""
    with _LOCK:
        loop = entry(op, data, cfg, st)
        loop.load(data, st)
        it = advance(loop, cfg, st.iteration, cfg.max_iter - 1,
                     lambda i: loop.replay(i, op, cfg))
        return loop.result(it)
