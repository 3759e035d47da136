"""Normative integer coefficient pipeline — batched torch (FORMAT.md).

Counterpart of sela_tpu/ops/coeffs.py: Q20 dequantization of companded
reflection coefficients and the integer Levinson recursion with per-step
saturation to [-2^23, 2^23-1]. The JAX package emulates int64 with int32
hi/lo pairs (ops/i64.py) because the TPU has none; here the products and
rounding shifts are native int64. Bit-identical to sela_tpu.ops.coeffs for
every int32 input.

`lpc_from_q` is the dispatching wrapper for the K1 kernel
(kernels/coeffs.py, csrc/lpc.cu); `lpc_from_q_reference` is its plain
version.
"""
from __future__ import annotations

import torch

from ..format import MAX_ORDER, REF_Q
from ..kernels.coeffs import lpc_from_q_cuda

G_LIM = 1 << REF_Q           # K1 clamps |g| <= 2^20 (a no-op for q in [-64, 63])
SAT_LO = -(1 << 23)
SAT_HI = (1 << 23) - 1


def dequantize_reflection(q: torch.Tensor) -> torch.Tensor:
    """[B, P] quantized -> [B, P] int32 Q20 reflection coefficients.

    m=1: 128*(q+64)^2 - 2^20 ; m=2: 2^20 - 128*(q+64)^2 ; m>=3: q*16384.
    Computed in int32 like the JAX version, so hostile q wraps identically.
    """
    q = q.to(torch.int32)
    one = 1 << REF_Q
    sq = 128 * (q + 64) * (q + 64)
    g = q * 16384
    col = torch.arange(q.shape[-1], device=q.device)[None, :]
    g = torch.where(col == 0, sq - one, g)
    return torch.where(col == 1, one - sq, g)


def reflection_to_lpc(g: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Integer Levinson: [B, P] Q20 reflection + [B] order ->
    [B, P] int32 Q20 direct-form coeffs (slots >= order stay zero).

    a'_i = SAT(a_i - rshift_round(k_m * a_{m-2-i}, 20)) for i < m-1, then
    a'_{m-1} = k_m, for each step m <= order. NORMATIVE.
    """
    B, P = g.shape
    order = order.to(torch.int64)
    cols = torch.arange(P, device=g.device)[None, :]
    g = torch.where(cols < order[:, None], g.to(torch.int64), 0)
    a = torch.zeros((B, P), dtype=torch.int64, device=g.device)
    for m in range(1, P + 1):
        k = g[:, m - 1 : m]
        active = (m <= order)[:, None]
        if m > 1:
            old = a[:, : m - 1]
            delta = (k * old.flip(1) + (1 << (REF_Q - 1))) >> REF_Q
            a[:, : m - 1] = torch.where(
                active, torch.clamp(old - delta, SAT_LO, SAT_HI), old
            )
        a[:, m - 1 : m] = torch.where(active, k, a[:, m - 1 : m])
    return a.to(torch.int32)


def lpc_from_q_reference(q: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: dequantize, clamp |g| <= 2^20, integer Levinson.

    Equals the Pallas `lpc_from_q_pallas` for every int32 q, and
    dequantize_reflection + reflection_to_lpc for every q in [-64, 63]
    (where the clamp is a no-op: every accepted stream).
    """
    g = torch.clamp(dequantize_reflection(q), -G_LIM, G_LIM)
    return reflection_to_lpc(g, order)


def lpc_from_q(q: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """q [B, 32] int32 + order [B] int32 -> c [B, 32] int32 Q20 coefficients.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K1 kernel (csrc/lpc.cu) or raises — there is no fallback.
    """
    if q.dtype != torch.int32 or order.dtype != torch.int32:
        raise TypeError(f"lpc_from_q needs int32 q and order, got "
                        f"{q.dtype} and {order.dtype}")
    if q.dim() != 2 or q.shape[1] != MAX_ORDER or order.shape != (q.shape[0],):
        raise ValueError(f"lpc_from_q needs q [B, {MAX_ORDER}] and order [B], "
                         f"got {tuple(q.shape)} and {tuple(order.shape)}")
    if not (q.is_contiguous() and order.is_contiguous()):
        raise ValueError("lpc_from_q needs contiguous q and order")
    if q.device != order.device:
        raise ValueError(f"q on {q.device} but order on {order.device}")
    if q.device.type == "cpu":
        return lpc_from_q_reference(q, order)
    if q.device.type != "cuda":
        raise ValueError(f"lpc_from_q: unsupported device {q.device}")
    return lpc_from_q_cuda(q, order)
