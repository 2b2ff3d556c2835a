"""Checkpoint / resume of a solver state (the JAX package's
``utils/checkpoint.py``, with ``torch.save`` in place of orbax).

The solver is resumable: ``run_segment`` / ``run_mv_segment`` advance a
state to an iteration bound and continue from any saved state, and the
step is deterministic given the state, so a resumed run gives what the
uninterrupted run gives, bit for bit.  ``cv_iht`` (univariate and
multivariate) and the streamed fits take ``checkpoint_dir`` /
``checkpoint_every`` (``models/univariate.py::run_segmented``).

A checkpoint is one file ``<directory>/step_<n>`` holding the state's
fields as CPU tensors and its host ``iteration``; only the newest two are
kept.  Each is written under a temporary name and then renamed over its
final one (``os.replace``), so a kill during a save never leaves a corrupt
newest step.  A solve on a ``ShardedPackedOp`` writes the same file, of
its whole state, from its first rank alone (``parallel/sharded_ops.py``),
so a checkpoint resumes on one device or on any mesh whose padded shapes
are the same.  This port does not read the JAX package's orbax
checkpoints, nor does the JAX package read these.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

_PREFIX = "step_"
_KEEP = 2


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{_PREFIX}{step}")


def save_state(directory: str, st, step: int,
               extra: dict | None = None) -> str:
    """Save the state dataclass ``st`` (an ``IHTState`` or ``MIHTState``)
    as ``directory/step_<step>``; keep the newest two steps.  Returns the
    path.  ``extra`` (name -> array) is saved beside the state under the
    key ``"extra"`` and never read back, as in the JAX package."""
    os.makedirs(directory, exist_ok=True)
    payload = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        payload[f.name] = v.detach().cpu() if isinstance(v, torch.Tensor) else v
    if extra:
        payload["extra"] = {k: torch.as_tensor(np.asarray(v))
                            for k, v in extra.items()}
    path = _path(directory, step)
    tmp = os.path.join(os.path.dirname(path),
                       f".{_PREFIX}{step}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)
    for s in sorted(all_steps(directory))[:-_KEEP]:
        os.remove(_path(directory, s))
    return path


def all_steps(directory: str) -> list[int]:
    """The steps saved in ``directory`` (none where it does not exist)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith(_PREFIX):
            try:
                out.append(int(name[len(_PREFIX):]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return max(steps) if steps else None


def load_payload(directory: str, step: int | None = None):
    """(the fields saved by :func:`save_state` at ``step`` (default the
    newest) as written, step), or None where nothing was saved: what a
    reader of the whole state needs that has no ``like`` of its shapes
    (a sharded solve's first rank, ``ShardedPackedOp.restore_state``)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    return torch.load(_path(directory, step), weights_only=True), step


def shape_error(directory: str, name: str, saved, want) -> ValueError:
    """The error of a saved field whose shape is not the solve's."""
    return ValueError(f"checkpoint in {directory}: field {name!r} has shape "
                      f"{tuple(saved)}, the solve's state {tuple(want)}")


def restore_state(directory: str, like, step: int | None = None):
    """The state saved by :func:`save_state` at ``step`` (default the
    newest) as the dataclass of ``like``, each tensor field cast to the
    dtype and device of ``like``'s; returns (state, step), or None where
    nothing was saved.  A field whose shape is not ``like``'s raises
    ValueError."""
    loaded = load_payload(directory, step)
    if loaded is None:
        return None
    payload, step = loaded
    fields = {}
    for f in dataclasses.fields(like):
        ref, v = getattr(like, f.name), payload[f.name]
        if isinstance(ref, torch.Tensor):
            if v.shape != ref.shape:
                raise shape_error(directory, f.name, v.shape, ref.shape)
            v = v.to(device=ref.device, dtype=ref.dtype)
        else:
            v = type(ref)(v)
        fields[f.name] = v
    return dataclasses.replace(like, **fields), step
