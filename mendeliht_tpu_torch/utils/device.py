"""Where what an entry point builds goes: the card unless the caller asks
for another device."""

from __future__ import annotations

import numpy as np
import torch

_FLOAT_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def float_dtype(dtype, fn: str = "dtype") -> torch.dtype:
    """The torch dtype of a fit's or genotypes' ``dtype``: float32 (the
    JAX package's default) or float64, given as a torch dtype, a numpy or
    jax dtype or its name.  Any other (bfloat16, None, ...) raises
    NotImplementedError naming ``fn``: the JAX package runs float32 and
    float64 fits, and so does the port."""
    if dtype in (torch.float32, torch.float64):
        return dtype
    try:
        # np.dtype(None) is float64: None names no dtype here
        if dtype is not None:
            return _FLOAT_DTYPES[np.dtype(dtype)]
    except (TypeError, KeyError):
        pass
    raise NotImplementedError(f"{fn}(dtype={dtype!r}): fits run in float32 "
                              "or float64 only")


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
