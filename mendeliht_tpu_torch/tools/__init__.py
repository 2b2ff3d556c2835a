"""Measurement labs of the port (the JAX package's ``tools/``), run as
modules, e.g. ``python -m mendeliht_tpu_torch.tools.kernel_lab5``."""
