"""The int32 chain of the roofline tool: T dependent steps of
y <- y * 1103515245 + 12345 (mod 2^32) on each element of x [rows, 128].

`int_chain` is the wrapper of the K9 kernel (kernels/chain.py,
csrc/int_chain.cu), a measuring instrument of the card's integer
multiply-add rate; `int_chain_reference` is its plain version.
"""
from __future__ import annotations

import torch

from ..kernels.chain import int_chain_cuda

LANES = 128
A = 1103515245
B = 12345
MASK = 0xFFFFFFFF


def int_chain_reference(x: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of K9: the T-step affine map composed by binary
    doubling, O(log T) tensor operations in int64, each product masked to
    32 bits (products wrap mod 2^64, which keeps the low 32 bits right)."""
    y = x.to(torch.int64) & MASK
    a, b = A, B              # the map y -> a y + b applied 2^i times
    while steps:
        if steps & 1:
            y = (y * a + b) & MASK
        a, b = (a * a) & MASK, (a * b + b) & MASK
        steps >>= 1
    return (((y + (1 << 31)) & MASK) - (1 << 31)).to(torch.int32)


def int_chain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """x [rows, 128] int32 on a CUDA device -> y [rows, 128] int32 after
    `steps` >= 0 chain steps.

    Launches the K9 kernel or raises: it is a measuring instrument of the
    card, so a CPU tensor is refused too (the plain version is
    int_chain_reference), and nothing falls back.
    """
    if x.dtype != torch.int32:
        raise TypeError(f"int_chain needs int32 x, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"int_chain needs x [rows, {LANES}], got "
                         f"{tuple(x.shape)}")
    if isinstance(steps, bool) or not isinstance(steps, int) or steps < 0:
        raise ValueError(f"int_chain needs an int steps >= 0, got {steps!r}")
    if not x.is_contiguous():
        raise ValueError("int_chain needs a contiguous x")
    if x.device.type != "cuda":
        raise ValueError(f"int_chain runs on a CUDA card only, got {x.device} "
                         "(the plain version is int_chain_reference)")
    return int_chain_cuda(x, steps)
