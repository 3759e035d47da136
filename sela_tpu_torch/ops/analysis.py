"""Float LPC analysis — batched torch float32 (non-normative).

Counterpart of sela_tpu/ops/analysis.py and of the two analysis kernels
that the JAX encode path runs (analyze_pallas):

- `autocorr_reference`: r[lag] = sum_n x[n] x[n+lag] / 2^30 for lags
  0..32, x scaled by 1/32768 first, float32 sums; the plain version of K3
  (csrc/autocorr.cu), whose wrapper is `autocorr`;
- `analyze_from_r_reference`: float Levinson-Durbin, order selection with
  the quantization-noise penalty, companded 7-bit quantization and the
  modeled cost; the plain version of K4 (csrc/levinson.cu), whose wrapper
  is `analyze_from_r`. It follows K4's formulas and order of operations
  (sela_tpu/kernels/encode.py::_make_levinson_kernel), not the jnp
  `select_order_and_cost`: K4 takes log2 as log * (1/ln 2) and keeps the
  first strict minimum in ascending order, where the jnp path takes log2
  and argmin, and the two can part on near-ties.

Every float operation here is one IEEE-rounded PyTorch operation, in K4's
order, so the kernel (built without contraction into FMA) can equal it on
the card given the same r. Float analysis only picks the stream the encoder
emits; any conforming decoder reconstructs it exactly (FORMAT.md "Design
invariant").
"""
from __future__ import annotations

import numpy as np
import torch

from ..format import (COEFF_BIT_COST, FRAME_SIZE, MAX_ORDER,
                      ORDER_QNOISE_PENALTY, Q_CLAMP_HI, Q_CLAMP_LO)
from ..kernels.encode import autocorr_cuda, levinson_cuda

LAGS = MAX_ORDER + 1
# K4's float32 constants, as Python floats that are exactly float32
LOG2E = float(np.float32(1.4426950408889634))
K_CLIP = float(np.float32(0.999999))
E_MIN = float(np.float32(1e-30))
ADJ_MIN = float(np.float32(1e-9))


def autocorr_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: [B, N] int32 (zero-padded rows) -> [B, 33]
    float32 autocorrelation of x / 32768 at lags 0..32."""
    xf = x.to(torch.float32) * (1.0 / 32768.0)
    n = x.shape[-1]
    cols = [(xf[:, : max(n - lag, 0)] * xf[:, lag:]).sum(dim=-1)
            for lag in range(LAGS)]
    return torch.stack(cols, dim=-1)


def quantize_reflection(g: torch.Tensor, m: int) -> torch.Tensor:
    """Reflection coefficient column m (float32 [B]) -> companded 7-bit
    int32 [B] (FORMAT.md): sqrt companding for m = 0, 1, linear beyond."""
    if m == 0:
        qf = torch.floor(64.0 * (torch.sqrt(2.0 * (g + 1.0)) - 1.0))
    elif m == 1:
        qf = torch.floor(64.0 * (torch.sqrt(2.0 * (1.0 - g)) - 1.0))
    else:
        qf = torch.floor(64.0 * g)
    return torch.clamp(qf, Q_CLAMP_LO, Q_CLAMP_HI).to(torch.int32)


def analyze_from_r_reference(r: torch.Tensor, n_valid: torch.Tensor,
                             max_order: int = MAX_ORDER):
    """Plain version of K4: r [B, 33] float32 + n_valid [B] ->
    (order [B] int32, q [B, 32] int32 zero beyond order, cost [B] float32).

    cost(m) = 0.5 n (log(max(err_m + m 2^-12 err_0, 1e-9)) * (1/ln 2)) + 7m
    for m <= max_order, the first strict minimum ascending; a row with
    r0 <= 0 has gamma = 0 and err = 1."""
    B = r.shape[0]
    r0 = r[:, 0]
    valid = r0 > 0.0
    one = torch.ones_like(r0)
    e = torch.where(valid, r0, one)
    err0 = e
    half_nf = 0.5 * n_valid.to(torch.float32)

    def model_bits(err):
        return half_nf * (torch.log(torch.clamp(err, min=ADJ_MIN)) * LOG2E)

    best_c = model_bits(err0)
    best_m = torch.zeros(B, dtype=torch.int32, device=r.device)
    a = torch.zeros((B, MAX_ORDER), dtype=torch.float32, device=r.device)
    q = torch.zeros((B, MAX_ORDER), dtype=torch.int32, device=r.device)
    for m in range(1, MAX_ORDER + 1):
        if m == 1:
            acc = r[:, 1]
        else:   # s = a_0 r_{m-1} + a_1 r_{m-2} + ..., summed left to right
            prods = a[:, : m - 1] * r[:, 1:m].flip(1)
            s = prods[:, 0]
            for i in range(1, m - 1):
                s = s + prods[:, i]
            acc = r[:, m] - s
        k = torch.where(e > 0.0, acc / torch.clamp(e, min=E_MIN), 0.0)
        k = torch.clamp(k, -K_CLIP, K_CLIP)
        if m > 1:
            old = a[:, : m - 1]
            a[:, : m - 1] = old - k[:, None] * old.flip(1)
        a[:, m - 1] = k
        e = e * (1.0 - k * k)
        q[:, m - 1] = quantize_reflection(torch.where(valid, k, 0.0), m - 1)
        if m <= max_order:
            adj = torch.where(valid, e, one) + (ORDER_QNOISE_PENALTY * m) * err0
            c = model_bits(adj) + float(COEFF_BIT_COST * m)
            better = c < best_c
            best_c = torch.where(better, c, best_c)
            best_m = torch.where(better, m, best_m)
    cols = torch.arange(MAX_ORDER, device=r.device)[None, :]
    q = torch.where(cols < best_m[:, None], q, 0)
    return best_m, q, best_c


def autocorr(x: torch.Tensor) -> torch.Tensor:
    """x [B, N] int32 (N <= 2048) -> r [B, 33] float32.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K3 kernel (csrc/autocorr.cu) or raises — there is no
    fallback."""
    if x.dtype != torch.int32:
        raise TypeError(f"autocorr needs int32 x, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] > FRAME_SIZE:
        raise ValueError(f"autocorr needs x [B, N <= {FRAME_SIZE}], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("autocorr needs a contiguous x")
    if x.device.type == "cpu":
        return autocorr_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"autocorr: unsupported device {x.device}")
    return autocorr_cuda(x)


def analyze_from_r(r: torch.Tensor, n_valid: torch.Tensor,
                   max_order: int = MAX_ORDER):
    """r [B, 33] float32 + n_valid [B] int32 -> (order, q, cost).

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the K4 kernel (csrc/levinson.cu) or raises — there is no
    fallback."""
    if r.dtype != torch.float32 or n_valid.dtype != torch.int32:
        raise TypeError(f"analyze_from_r needs float32 r and int32 n_valid, "
                        f"got {r.dtype} and {n_valid.dtype}")
    if r.dim() != 2 or r.shape[1] != LAGS or n_valid.shape != (r.shape[0],):
        raise ValueError(f"analyze_from_r needs r [B, {LAGS}] and n_valid [B],"
                         f" got {tuple(r.shape)} and {tuple(n_valid.shape)}")
    if not 1 <= max_order <= MAX_ORDER:
        raise ValueError(f"max_order {max_order} outside [1, {MAX_ORDER}]")
    if not (r.is_contiguous() and n_valid.is_contiguous()):
        raise ValueError("analyze_from_r needs contiguous r and n_valid")
    if r.device != n_valid.device:
        raise ValueError(f"r on {r.device} but n_valid on {n_valid.device}")
    if r.device.type == "cpu":
        return analyze_from_r_reference(r, n_valid, max_order)
    if r.device.type != "cuda":
        raise ValueError(f"analyze_from_r: unsupported device {r.device}")
    return levinson_cuda(r, n_valid, max_order)


def analyze(x: torch.Tensor, n_valid: torch.Tensor, max_order: int = MAX_ORDER):
    """[B, N] int32 rows + [B] counts -> (order [B] int32, q [B, 32] int32,
    cost [B] float32): K3 then K4, as sela_tpu analyze_pallas."""
    return analyze_from_r(autocorr(x), n_valid, max_order)
