"""K9 on the card: launch of csrc/int_chain.cu (the int32 chain microkernel).

Replaces tools/roofline.py::chain_kernel (the Pallas probe that
vpu_microbench times). The source says what bounds it and why each step is
its own multiply-add; the checked wrapper and the plain version beside it
are ops/chain.py::int_chain and ::int_chain_reference.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..utils.build import build_cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "int_chain.cu")
LIB_NAME = "sela_int_chain"
UNROLL = 16           # steps an iteration of the kernel's main loop
launches = 0          # kernel launches since the last reset (chip_smoke.py)
_lib = None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_cuda(LIB_NAME, SOURCE))
        lib.sela_int_chain.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.sela_int_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def int_chain_cuda(x: torch.Tensor, steps: int) -> torch.Tensor:
    """Launch K9 on x's device and stream; x [rows, 128] int32, contiguous,
    on a CUDA device (ops/chain.py::int_chain checks)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"int_chain_cuda needs a CUDA tensor, got {x.device}")
    lib = load()
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sela_int_chain(x.data_ptr(), y.data_ptr(), x.shape[0], steps,
                                 stream)
    if err:
        raise RuntimeError(f"int_chain kernel launch failed: CUDA error {err}")
    launches += 1
    return y
