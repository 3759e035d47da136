"""The Rice packer on the card: the launcher of csrc/pack.cu.

The kernel replaces sela_tpu/ops/pack.py::pack_blocks_device, which is jnp
and not a Pallas kernel. The dispatching wrapper with its checks, and the
plain version beside it, are ops/pack.py. The launchers take checked,
contiguous tensors on one CUDA device, launch on the current stream and
count the launch: `pack_blocks_cuda` (entry `sela_pack`, rows of a dense
array) and `pack_blocks_at_cuda` (entry `sela_pack_at`, rows at given word
offsets of one flat buffer; the encoder's).
"""
from __future__ import annotations

import ctypes
import os

import torch

from ..utils.build import build_cuda

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                      "pack.cu")
LIB_NAME = "sela_pack"
launches = 0          # kernel launches since the last reset (chip_smoke.py)
_lib = None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; idempotent."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_cuda(LIB_NAME, SOURCE))
        lib.sela_pack.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.sela_pack.restype = ctypes.c_int
        lib.sela_pack_at.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.sela_pack_at.restype = ctypes.c_int
        _lib = lib
    return _lib


def pack_blocks_cuda(values: torch.Tensor, k: torch.Tensor,
                     n_valid: torch.Tensor, max_words: int):
    """values [B, N] int32 (N <= 2048), k and n_valid [B] int32 ->
    (words [B, max_words] int32 holding the uint32 bits, nwords [B] int64)."""
    global launches
    if values.device.type != "cuda":
        raise ValueError(f"pack kernel needs CUDA tensors, got {values.device}")
    lib = load()
    B, N = values.shape
    words = torch.empty((B, max_words), dtype=torch.int32, device=values.device)
    nwords = torch.empty(B, dtype=torch.int64, device=values.device)
    if B == 0:
        return words, nwords
    with torch.cuda.device(values.device):
        err = lib.sela_pack(values.data_ptr(), k.data_ptr(), n_valid.data_ptr(),
                            words.data_ptr(), nwords.data_ptr(), B, N, max_words,
                            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {err}")
    launches += 1
    return words, nwords


def pack_blocks_at_cuda(values: torch.Tensor, k: torch.Tensor,
                        n_valid: torch.Tensor, offs: torch.Tensor,
                        caps: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """values [B, N] int32 (N <= 2048), k, n_valid, caps [B] int32, offs [B]
    int64, words [T] int32 (written in place: row b at words[offs[b] :
    offs[b] + caps[b]]) -> nwords [B] int64 (-1 where k is outside [0, 30]).
    Reads no device value: the shared buffer holds N + 1 words, and a row
    with a larger cap packs in its span of words."""
    global launches
    if values.device.type != "cuda":
        raise ValueError(f"pack kernel needs CUDA tensors, got {values.device}")
    lib = load()
    B, N = values.shape
    nwords = torch.empty(B, dtype=torch.int64, device=values.device)
    if B == 0:
        return nwords
    with torch.cuda.device(values.device):
        err = lib.sela_pack_at(values.data_ptr(), k.data_ptr(),
                               n_valid.data_ptr(), offs.data_ptr(),
                               caps.data_ptr(), words.data_ptr(),
                               nwords.data_ptr(), B, N, words.numel(), N + 1,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {err}")
    launches += 1
    return nwords
