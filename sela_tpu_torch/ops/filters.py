"""Q20 IIR synthesis — plain torch version (FORMAT.md, normative).

Counterpart of sela_tpu/ops/filters.py::iir_synthesize and the plain
version of the K2/K7 kernel (kernels/iir.py, csrc/iir.cu):

    x[n] = e[n] + low32(rshift_round(sum_{j=1..32} c_j * x[n-j], 20))

with the sum of the products in int64 and the history kept as the wrapped
int32 x values, as the JAX scan path and both Pallas kernels keep it (the
numpy oracle keeps an int64 history instead; the two agree on every valid
stream). A serial Python loop over time, vectorized over rows and taps.
"""
from __future__ import annotations

import torch

from ..format import REF_Q


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with the same low 32 bits (as int64)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def iir_synthesize_reference(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """e [B, N] int32 residues, c [B, P] int32 Q20 coefficients (zero beyond
    order) -> x [B, N] int32.

    Exact for |c| <= 2^23 (every coefficient the integer Levinson yields):
    then 32 products of an int32 history with c sum to less than 2^59, so
    the int64 sum cannot overflow, and wrapping the rounded prediction and
    e + pred to 32 bits gives the JAX paths' mod-2^32 result for every
    int32 residue.
    """
    B, N = e.shape
    P = c.shape[1]
    crev = c.to(torch.int64).flip(1)            # crev[:, P-j] = c_j
    hist = torch.zeros((B, P + N), dtype=torch.int64, device=e.device)
    e64 = e.to(torch.int64)
    half = 1 << (REF_Q - 1)
    for n in range(N):
        acc = (hist[:, n : n + P] * crev).sum(dim=1)   # window = x[n-P..n-1]
        pred = _wrap_i32((acc + half) >> REF_Q)
        hist[:, n + P] = _wrap_i32(e64[:, n] + pred)
    return hist[:, P:].to(torch.int32)
