"""K2/K7 on the card: the IIR synthesis kernel (csrc/iir.cu) and its wrapper.

One int64 CUDA kernel replaces both sela_tpu/kernels/iir.py kernels: the
limb-split fast one (K2, <=24-bit streams) and the generic one (K7, every
int32 input), because a 64-bit sum of 32x32->64 products is exact for both
domains. The plain version is ops/filters.py::iir_synthesize_reference.
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..format import MAX_ORDER
from ..ops.filters import iir_synthesize_reference
from ..utils.build import build_cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "iir.cu")
LIB_NAME = "sela_iir"
launches = 0          # kernel launches since the last reset (chip_smoke.py)
_lib = None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_cuda(LIB_NAME, SOURCE))
        lib.sela_iir_synthesize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.sela_iir_synthesize.restype = ctypes.c_int
        _lib = lib
    return _lib


def iir_synthesize(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """e [B, N] int32 residues + c [B, 32] int32 Q20 coefficients (zero
    beyond order) -> x [B, N] int32.

    On a CPU tensor this runs the plain version; on a CUDA tensor it
    launches the kernel or raises — there is no fallback.
    """
    global launches
    if e.dtype != torch.int32 or c.dtype != torch.int32:
        raise TypeError(f"iir_synthesize needs int32 e and c, got "
                        f"{e.dtype} and {c.dtype}")
    if e.dim() != 2 or c.shape != (e.shape[0], MAX_ORDER):
        raise ValueError(f"iir_synthesize needs e [B, N] and c [B, {MAX_ORDER}],"
                         f" got {tuple(e.shape)} and {tuple(c.shape)}")
    if not (e.is_contiguous() and c.is_contiguous()):
        raise ValueError("iir_synthesize needs contiguous e and c")
    if e.device != c.device:
        raise ValueError(f"e on {e.device} but c on {c.device}")
    if e.device.type == "cpu":
        return iir_synthesize_reference(e, c)
    if e.device.type != "cuda":
        raise ValueError(f"iir_synthesize: unsupported device {e.device}")
    lib = load()
    x = torch.empty_like(e)
    with torch.cuda.device(e.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sela_iir_synthesize(e.data_ptr(), c.data_ptr(), x.data_ptr(),
                                      e.shape[0], e.shape[1], stream)
    if err:
        raise RuntimeError(f"iir kernel launch failed: CUDA error {err}")
    launches += 1
    return x
