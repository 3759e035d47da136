"""K1 on the card: launch of csrc/lpc.cu (dequantize + integer Levinson).

Replaces sela_tpu/kernels/coeffs.py::_lpc_kernel (lpc_from_q_pallas). The
source says what bounds it and how it is laid out; the dispatching wrapper
with its checks is ops/coeffs.py::lpc_from_q, and the plain version beside
it is ops/coeffs.py::lpc_from_q_reference.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..utils.build import build_cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "lpc.cu")
LIB_NAME = "sela_lpc"
launches = 0          # kernel launches since the last reset (chip_smoke.py)
_lib = None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_cuda(LIB_NAME, SOURCE))
        lib.sela_lpc_from_q.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.sela_lpc_from_q.restype = ctypes.c_int
        _lib = lib
    return _lib


def lpc_from_q_cuda(q: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Launch K1 on q's device and stream; q [B, 32], order [B], both int32,
    contiguous, on one CUDA device (ops/coeffs.py::lpc_from_q checks)."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"lpc_from_q_cuda needs CUDA tensors, got {q.device}")
    lib = load()
    c = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sela_lpc_from_q(q.data_ptr(), order.data_ptr(), c.data_ptr(),
                                  q.shape[0], stream)
    if err:
        raise RuntimeError(f"lpc kernel launch failed: CUDA error {err}")
    launches += 1
    return c
