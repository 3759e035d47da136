"""Device decode step: residues + plan -> PCM for one chunk of frames.

Counterpart of sela_tpu/codec/pipeline.py::decode_step, with the same
layouts at its boundary: residues [F, C, S], qcoeffs [F, C, 32], order and
sftype [F, C]. Kernel routing depends on the device only: on CUDA tensors
the K1 and K2/K7 kernels serve every bit depth; on CPU tensors their plain
versions run.
"""
from __future__ import annotations

import torch

from ..format import SF_MID
from ..kernels.iir import iir_synthesize
from ..ops.coeffs import lpc_from_q


def _inverse_mid_side(mid: torch.Tensor, side: torch.Tensor):
    left = mid + ((side + (side & 1)) >> 1)
    return left, left - side


def decode_step(residues: torch.Tensor, qcoeffs: torch.Tensor,
                order: torch.Tensor, sftype: torch.Tensor,
                out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Inverse of the encode step for one chunk: PCM [F, C, S] of out_dtype.

    residues may arrive as int16 (the host sends that wire dtype when every
    value fits); codec math is int32. out_dtype=torch.int16 halves the
    device->host transfer for <=16-bit streams.
    """
    F, C, S = residues.shape
    B = F * C
    # CHANNEL-MAJOR rows, as the JAX decode_step lays them out: the row
    # order does not change any row's result
    q_cm = qcoeffs.transpose(0, 1).reshape(B, -1).to(torch.int32).contiguous()
    o_cm = order.transpose(0, 1).reshape(B).to(torch.int32).contiguous()
    c = lpc_from_q(q_cm, o_cm)
    e = residues.transpose(0, 1).reshape(B, S).to(torch.int32).contiguous()
    xc = iir_synthesize(e, c).view(C, F, S)
    # inverse mid/side fused with the channel-major -> [F, C, S] restore:
    # one where per output channel and one stack
    chans = []
    for p in range(C // 2):
        li, ri = 2 * p, 2 * p + 1
        is_ms = (sftype[:, li] == SF_MID)[:, None]
        left, right = _inverse_mid_side(xc[li], xc[ri])
        chans.append(torch.where(is_ms, left, xc[li]))
        chans.append(torch.where(is_ms, right, xc[ri]))
    if C % 2:
        chans.append(xc[C - 1])
    return torch.stack(chans, dim=1).to(out_dtype)
