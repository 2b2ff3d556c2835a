"""The reading of the program's ``iht.*`` spans, on hand-made profiler
events: device ops put down to the innermost span open at their launch,
the calls' idle time split between ``iht.solve``, the rest of the entry
span and outside it, and the readers of the eight span metrics."""

from types import SimpleNamespace as E

import pytest
import torch

from benchmark import run, spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, thread=1, linked=0,
       annotation=False):
    return E(name=name, device_type=device, time_range=E(start=start, end=end),
             thread=thread, id=id, linked_correlation_id=linked,
             is_user_annotation=annotation)


def call(top, at=0):
    """One call of ``top`` ("iht.fit" or "iht.cv") from ``at`` (us)."""
    events = [
        ev(trace.CALL, 0, 100),
        ev(top, 5, 95),
        ev("iht.build", 5, 15),
        ev("iht.solve", 20, 80),
        ev("iht.iteration", 22, 60),
        ev("iht.project", 25, 35),
        ev("cudaLaunchKernel", 26, 27, id=11),
        ev("iht.forward", 36, 45),
        ev("aten::mm", 37, 44, id=500),
        ev("iht.sync", 46, 58),
        ev("iht.sync", 61, 79),
        ev("iht.fetch", 82, 94),
        ev("cudaLaunchKernel", 83, 84, id=13),
        ev("cudaLaunchKernel", 1, 2, id=10),         # outside every span
        ev("iht.iteration", 30, 40, thread=2),       # another thread's
        ev("topk", 40, 50, CUDA, id=11),             # by its launch
        ev("gemv", 50, 55, CUDA, id=99, linked=500),  # by its host op
        ev("fetch_kernel", 85, 90, CUDA, id=13),
        ev("first", 2, 4, CUDA, id=10),
        ev("iht.solve", 20, 80, CUDA, annotation=True),  # a device mark
    ]
    for e in events:
        e.time_range.start += at
        e.time_range.end += at
    return events


# busy 2-4, 40-55, 85-90 of the call's 0-100: idle 78 us, of which 45 in
# iht.solve (20-40, 55-80), 25 in the rest of the entry span (5-20, 80-85,
# 90-95) and 8 outside it (0-2, 4-5, 95-100)
IDLE = {"calls": 78e-6, "solve": 45e-6, "entry": 25e-6, "outside": 8e-6}


def test_device_ops_by_innermost_span():
    s = spans.read(dict(events=call("iht.fit")))
    assert s["device_s"] == pytest.approx({
        "iht.project": 10e-6, "iht.forward": 5e-6, "iht.fetch": 5e-6,
        None: 2e-6})
    assert s["count"]["iht.iteration"] == 1 and s["count"]["iht.sync"] == 2
    assert s["syncs_in_solve"] == 2 and s["calls"] == 1


def test_idle_splits_into_solve_entry_and_outside():
    s = spans.read(dict(events=call("iht.fit")))
    assert s["idle_s"] == pytest.approx(IDLE)
    idle = s["idle_s"]
    parts = idle["solve"] + idle["entry"] + idle["outside"]
    assert parts == pytest.approx(idle["calls"])


@pytest.mark.parametrize("interval_ops", [
    ("_intersect", [(0, 10), (20, 30)], [(5, 25)], [(5, 10), (20, 25)]),
    ("_subtract", [(0, 10), (20, 30)], [(5, 25)], [(0, 5), (25, 30)]),
    ("_subtract", [(0, 30)], [(5, 10), (10, 12), (20, 40)],
     [(0, 5), (12, 20)]),
], ids=["intersect", "subtract", "subtract_touching"])
def test_interval_arithmetic(interval_ops):
    name, a, b, want = interval_ops
    assert getattr(spans, name)(a, b) == want


WANT = {
    "fit": {"iterations_per_fit": 1.0, "syncs_per_iteration.fit": 2.0,
            "solver_idle_ms.fit": 0.045, "entry_idle_ms.fit": 0.025},
    "cv": {"iterations_per_cv": 1.0, "entry_idle_ms.cv": 0.025,
           "topk_device_ms.cv": 0.010, "forward_device_ms.cv": 0.005},
}


@pytest.mark.parametrize("kind", sorted(WANT))
def test_readers(kind):
    other = "cv" if kind == "fit" else "fit"
    # two calls: each reader gives a call's share
    events = call(spans.ENTRY[kind]) + call(spans.ENTRY[kind], at=1000)
    t = dict(kind=kind, events=events)
    for name, want in WANT[kind].items():
        assert run.metric_reader(name)(t) == pytest.approx(want), name
    for name in WANT[other]:
        assert run.metric_reader(name)(t) is None, name


@pytest.mark.parametrize("kind", sorted(WANT))
def test_readers_without_the_programs_spans(kind):
    """A program that opens no span (the parent of the spans) gives None,
    and no error."""
    events = [e for e in call(spans.ENTRY[kind])
              if not e.name.startswith(spans.PREFIX)]
    t = dict(kind=kind, events=events)
    for name in WANT[kind]:
        assert run.metric_reader(name)(t) is None, name


def test_read_once_a_trace():
    """The readers of one traced run share one reading of its events; a
    new trace is read anew."""
    t = dict(kind="fit", events=call("iht.fit"))
    first = spans.read(t)
    assert spans.read(t) is first
    assert spans.read(dict(t, events=call("iht.fit"))) is not first
