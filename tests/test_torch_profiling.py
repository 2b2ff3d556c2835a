"""The port's profiling summary: device busy time as a union of intervals,
launches and syncs counted from host events, the heaviest device activities
first.  On a CUDA card (marker ``cuda``), a trace of a score pass shows the
kernel's device time.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mendeliht_tpu_torch.genotype.snparray import _bytes_to_words, pack_codes
from mendeliht_tpu_torch.ops import kernels
from mendeliht_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch intra-op thread for this module, restored after it: where
    other test processes keep every core busy, the default thread pool
    oversubscribes the cores and each small op waits on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, start, end, device=CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),            # overlap counts once
    ([(20, 30), (0, 10), (2, 3)], 20.0),   # unsorted, nested, a gap
    ([(0, 10), (10, 20)], 20.0),           # touching
])
def test_union_us(spans, want):
    assert profiling._union_us(spans) == want


def test_summarize_counts_device_time_launches_and_syncs():
    events = [
        _event("cudaLaunchKernel", 0, 4, CPU),
        _event("cudaLaunchKernel", 5, 7, CPU),
        _event("aten::add", 0, 9, CPU),
        _event("cudaStreamSynchronize", 10, 40, CPU),
        _event("score", 6, 26),
        _event("score", 30, 40),
        _event("add", 20, 28),             # overlaps the first score
    ]
    s = profiling.summarize(events, wall_s=50e-6, top=1)
    assert s["device_busy_ms"] == pytest.approx(0.032)     # 6-28, 30-40
    assert s["wall_ms"] == pytest.approx(0.05)
    assert s["idle_share"] == pytest.approx(1 - 32 / 50)
    assert (s["device_ops"], s["launches"], s["syncs"]) == (3, 2, 1)
    assert s["launch_host_ms"] == pytest.approx(0.006)
    assert s["sync_wait_ms"] == pytest.approx(0.03)
    assert s["kernels"] == [("score", pytest.approx(0.03), 2)]


def test_trace_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with profiling.trace():
            pass


@pytest.mark.cuda
def test_trace_shows_score_kernel_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=(4096, 2000), dtype=np.uint8)
    words = torch.from_numpy(_bytes_to_words(pack_codes(codes))).cuda()
    rhs = torch.ones((4 * words.shape[1], 8), device="cuda")
    kernels.xt_dots_words(words, rhs, want_missing=False)       # build, warm
    with profiling.trace(logdir=str(tmp_path)) as s:
        for _ in range(3):
            kernels.xt_dots_words(words, rhs, want_missing=False)
    assert 0 < s["device_busy_ms"] <= s["wall_ms"]
    assert s["launches"] >= 3 and s["syncs"] >= 1
    names = [name for name, _, _ in s["kernels"]]
    assert any("xt_dots" in name for name in names), names
    assert (tmp_path / "trace.json").is_file()
