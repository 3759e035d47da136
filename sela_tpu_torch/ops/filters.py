"""Q20 prediction filters — plain torch versions (FORMAT.md, normative).

Encode: `fir_residues_reference` is the counterpart of both
sela_tpu/ops/filters.py::fir_residues and ::fir_residues_fast (one int64
function is exact for every int32 input, so the limb-split fast path has
no counterpart), and `fir_rice_reference` adds the Rice bit counts: it is
the plain version of the K5 kernel (csrc/fir_rice.cu), whose dispatching
wrapper is `fir_rice`.

Decode: `iir_synthesize_reference` is the counterpart of
sela_tpu/ops/filters.py::iir_synthesize and the plain version of the K2/K7
kernel (kernels/iir.py, csrc/iir.cu):

    x[n] = e[n] + low32(rshift_round(sum_{j=1..32} c_j * x[n-j], 20))

with the sum of the products in int64 and the history kept as the wrapped
int32 x values, as the JAX scan path and both Pallas kernels keep it (the
numpy oracle keeps an int64 history instead; the two agree on every valid
stream). A serial Python loop over time, vectorized over rows and taps.
"""
from __future__ import annotations

import torch

from ..format import FRAME_SIZE, MAX_ORDER, REF_Q, RESIDUE_LIMIT
from ..kernels.encode import fir_rice_cuda
from .rice import bit_counts, zigzag


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


def fir_residues_reference(x: torch.Tensor, c: torch.Tensor,
                           order: torch.Tensor, n_valid: torch.Tensor):
    """e[n] = x[n] - rshift_round(sum_{j=1..32} c_j x[n-j], 20), with zero
    history before the row, for x [B, N] int32, c [B, 32] int32 Q20
    coefficients (zero beyond order), order and n_valid [B].

    Returns (e [B, N] int32, eff_order [B] int32). Only samples n < n_valid
    count: a row whose residues are not all strictly inside +-2^30 there
    falls back to order 0 (e = x, eff_order 0); e is zero beyond n_valid.
    The products and their sum are int64, which is exact for |c| <= 2^23
    (every coefficient the integer Levinson yields) and every int32 x.
    """
    B, N = x.shape
    x64 = x.to(torch.int64)
    acc = torch.zeros((B, N), dtype=torch.int64, device=x.device)
    for j in range(1, c.shape[1] + 1):   # rows under 32 samples: j > N adds
        acc[:, j:] += c[:, j - 1 : j].to(torch.int64) * x64[:, : max(N - j, 0)]
    e = x64 - ((acc + (1 << (REF_Q - 1))) >> REF_Q)
    valid = torch.arange(N, device=x.device)[None, :] < n_valid[:, None]
    inside = (e > -RESIDUE_LIMIT) & (e < RESIDUE_LIMIT)
    ok = torch.all(~valid | inside, dim=1)
    e32 = torch.where(ok[:, None], e, x64).to(torch.int32)
    return (torch.where(valid, e32, 0),
            torch.where(ok, order, 0).to(torch.int32))


def fir_rice_reference(x: torch.Tensor, c: torch.Tensor, order: torch.Tensor,
                       n_valid: torch.Tensor):
    """Plain version of K5: fir_residues_reference plus the [B, 32] bit
    counts of the residues' zigzag codes (sela_tpu fir_rice_pallas)."""
    e, eff_order = fir_residues_reference(x, c, order, n_valid)
    return e, eff_order, bit_counts(zigzag(e))


def fir_rice(x: torch.Tensor, c: torch.Tensor, order: torch.Tensor,
             n_valid: torch.Tensor):
    """x [B, N] int32 (N <= 2048), c [B, 32] int32, order and n_valid [B]
    int32 -> (e [B, N] int32, eff_order [B] int32, counts [B, 32] int32).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K5 kernel (csrc/fir_rice.cu) or raises — there is no
    fallback.
    """
    args = (x, c, order, n_valid)
    if any(a.dtype != torch.int32 for a in args):
        raise TypeError("fir_rice needs int32 x, c, order and n_valid, got "
                        + ", ".join(str(a.dtype) for a in args))
    B = x.shape[0] if x.dim() == 2 else -1
    if (x.dim() != 2 or c.shape != (B, MAX_ORDER) or order.shape != (B,)
            or n_valid.shape != (B,)):
        raise ValueError(f"fir_rice needs x [B, N], c [B, {MAX_ORDER}], order "
                         f"and n_valid [B], got "
                         + ", ".join(str(tuple(a.shape)) for a in args))
    if x.shape[1] > FRAME_SIZE:
        raise ValueError(f"fir_rice: rows of {x.shape[1]} samples exceed "
                         f"{FRAME_SIZE}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("fir_rice needs contiguous x, c, order and n_valid")
    if any(a.device != x.device for a in args):
        raise ValueError("fir_rice needs x, c, order and n_valid on one device")
    if x.device.type == "cpu":
        return fir_rice_reference(x, c, order, n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"fir_rice: unsupported device {x.device}")
    return fir_rice_cuda(x, c, order, n_valid)
