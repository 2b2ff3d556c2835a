"""Shared pieces of the benchmark's CPU tests: cells cut to a tiny size
(512 samples x 4,096 SNPs) that run through the harness on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(n=512, p=4096)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)`` -> (bench, cell, config cut to TINY, traffic)."""
    from benchmark import run

    def load(name):
        bench, cell, config, traffic = run.load_cell(name)
        return bench, cell, dict(config, **TINY), traffic
    return load


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
