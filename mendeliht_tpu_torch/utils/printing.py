"""Console banners (reference src/utilities.jl:920-951)."""

from __future__ import annotations

import sys


def print_iht_signature(io=None):
    io = io or sys.stdout
    print("****        mendeliht_tpu_torch (PyTorch/CUDA IHT)             ****", file=io)
    print("****   feature-parity target: MendelIHT.jl (OpenMendel) —      ****", file=io)
    print("****   B. Chu, K. Keys, C. German, H. Zhou, J. Zhou, E. Sobel,  ****", file=io)
    print("****   J. Sinsheimer, K. Lange;  please cite their papers:      ****", file=io)
    print("****       https://doi.org/10.1093/gigascience/giaa044          ****", file=io)
    print("****       https://doi.org/10.1093/bioinformatics/btad193       ****", file=io)
    print("", file=io)


def print_parameters(io, k, dist, link, tol, max_iter, min_iter, device):
    """The parameter block of a fit; weight scaling, group projection and
    debiasing are not ported yet, so they print as off."""
    io = io or sys.stdout
    regression = {"normal": "linear"}.get(dist, dist)
    print(f"Running sparse {regression} regression", file=io)
    print(f"Backend = torch {device}", file=io)
    print(f"Link function = {link}", file=io)
    print(f"Sparsity parameter (k) = {k}", file=io)
    print("Prior weight scaling = off", file=io)
    print("Doubly sparse projection = off", file=io)
    print("Debias = off", file=io)
    print(f"Max IHT iterations = {max_iter}", file=io)
    print(f"Converging when tol < {tol} and iteration >= {min_iter}:\n", file=io)
