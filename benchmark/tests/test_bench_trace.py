"""The reading of a trace, on hand-made profiler events: device-busy
union, the score's device ops by their launches inside the score's range,
the idle gaps by the host range open, and the metric readers."""

from types import SimpleNamespace as E

import pytest
import torch

from benchmark import run, trace, workcount

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, thread=1):
    return E(name=name, device_type=device, time_range=E(start=start, end=end),
             thread=thread, id=id, linked_correlation_id=0)


EVENTS = [
    ev(trace.CALL, 0, 100),
    ev(trace.SCORE, 10, 20),
    ev("cudaLaunchKernel", 11, 12, id=7),        # in the score's range
    ev("cudaLaunchKernel", 30, 31, id=8),        # outside it
    ev("aten::copy_", 40, 90),
    ev("cudaStreamSynchronize", 91, 99),
    ev("score_kernel", 15, 35, CUDA, id=7),
    ev("other_kernel", 35, 45, CUDA, id=8),
    ev(trace.SCORE, 15, 35, CUDA, id=0),          # the range's device mark
]


def test_summarize():
    peak = workcount.peaks("NVIDIA H100 80GB HBM3")
    t = trace.summarize(EVENTS, 100e-6, [(10_000, 1_000_000, 1)], peak)
    assert t["busy_s"] == pytest.approx(30e-6)       # 15..45, the mark not
    assert t["score_device_s"] == pytest.approx(20e-6)
    assert t["score_kernels"] == 1 and t["score_links"] == (1, 0, 0)
    assert t["launches"] == 2 and t["syncs"] == 1
    assert t["device_ops"] == 2 and t["enqueues"] == 2
    assert t["score_bound_s"] == workcount.score_bound_s(10_000, 1_000_000,
                                                         1, peak)
    gaps = dict(t["breakdown"]["idle_gaps"])
    # 0..15 opens in the call, 45..100 inside aten::copy_ from 45
    assert gaps == pytest.approx({trace.CALL: 15e-6, "aten::copy_": 55e-6})
    assert [n for n, _ in t["breakdown"]["device_ops"]] == [
        "score_kernel", "other_kernel"]


def test_readers():
    t = dict(kind="fit", calls=2, wall_s=1.0, busy_s=0.25, score_kernels=5,
             score_device_s=0.1, score_bound_s=0.05, launches=4000)
    read = run.metric_reader
    assert read("score_roofline.fit")(t) == pytest.approx(50.0)
    assert read("launches_per_fit")(t) == 2000
    assert read("idle_share.fit")(t) == pytest.approx(0.75)
    assert read("score_roofline.cv")(t) is None
    assert read("solver_device_ms.cv")(t) is None
    t.update(kind="cv")
    assert read("solver_device_ms.cv")(t) == pytest.approx(75.0)
    assert read("launches_per_fit")(t) is None
    t.update(score_kernels=0)
    assert read("score_roofline.cv")(t) is None      # never a 0 share
