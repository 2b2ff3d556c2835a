"""Where what an entry point builds goes: the card unless the caller asks
for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the first CUDA device.  Where
    there is none, None raises rather than fall back to the CPU: a caller
    who wants the CPU passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", 0)
