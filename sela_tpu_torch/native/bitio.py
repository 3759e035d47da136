"""ctypes bindings for the native Rice bitstream library (bitio.cpp).

The port's copy of sela_tpu/native/bitio.py, reduced to what decode needs:
the single-pass frame scan and the threaded block unpacker. The library is
built with g++ from this directory's bitio.cpp at first use into the
port's build directory (utils/build.py); a failed build raises — the
decoder has no numpy unpacker to switch to.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.build import build_library

_SRC = os.path.join(os.path.dirname(__file__), "bitio.cpp")
_lib = None


def load() -> ctypes.CDLL:
    """Build (if stale) and load the library; idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    path = build_library(
        "selabitio", [_SRC],
        ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"],
    )
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rice_unpack_blocks.argtypes = [
        u32p, i64p, i32p, i64p, i32p, i32p, i32p, ctypes.c_int64, i32p,
    ]
    lib.rice_unpack_blocks.restype = None
    lib.sela_scan_frames.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_uint32, ctypes.c_int32,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        u32p, ctypes.POINTER(ctypes.c_int64),
        u32p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sela_scan_frames.restype = ctypes.c_int64
    _lib = lib
    return lib


def unpack_blocks_flat(words: np.ndarray, word_offs: np.ndarray,
                       word_counts: np.ndarray, counts: np.ndarray,
                       ks: np.ndarray, ks4: np.ndarray | None = None) -> np.ndarray:
    """Returns concatenated int32 values (block i has counts[i] values).

    Block i is words[word_offs[i] : word_offs[i] + word_counts[i]], Rice
    parameter ks[i] (32 = partition marker, sub-ks byte-packed in ks4[i])."""
    lib = load()
    n = len(counts)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    word_offs = np.ascontiguousarray(word_offs, dtype=np.int64)
    word_counts = np.ascontiguousarray(word_counts, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    k4 = (np.zeros(n, np.int32) if ks4 is None
          else np.ascontiguousarray(ks4, dtype=np.int32))
    if not (len(word_offs) == len(word_counts) == len(ks) == len(k4) == n):
        raise ValueError("unpack_blocks_flat: per-block arrays differ in length")
    if n and int((word_offs + word_counts).max()) > len(words):
        raise ValueError("unpack_blocks_flat: block words out of range")
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1].astype(np.int64), out=offs[1:])
    out = np.zeros(int(counts.astype(np.int64).sum()), dtype=np.int32)
    lib.rice_unpack_blocks(words, word_offs, word_counts, offs, counts, ks,
                           k4, n, out)
    return out


def scan_frames(buf: bytes, pos: int, num_frames: int, channels: int,
                sync: int, max_samples: int):
    """Single-pass native container scan (FORMAT.md frame layout).

    Returns (fields dict, end_pos) or raises ValueError at the first
    structural error. fields: n_samples [F]; per-subframe arrays [F*C] in
    file order (channel, sftype, order, k_coeff, nw_coeff, k_res, k_res4,
    nw_res); coeff_words / res_words — aligned uint32 arrays concatenated in
    subframe order, ready for unpack_blocks_flat.
    """
    lib = load()
    F, C = num_frames, channels
    b = np.frombuffer(buf, dtype=np.uint8)
    n_samples = np.zeros(F, np.int32)
    sf = {k: np.zeros(F * C, np.int32)
          for k in ("channel", "sftype", "order", "k_coeff", "nw_coeff",
                    "k_res", "k_res4", "nw_res")}
    cap = max((len(buf) - pos) // 4 + 1, 1)
    coeff_words = np.zeros(cap, np.uint32)
    res_words = np.zeros(cap, np.uint32)
    ct = ctypes.c_int64(0)
    rt = ctypes.c_int64(0)
    end = lib.sela_scan_frames(
        b, len(buf), pos, F, C, sync, max_samples,
        n_samples, sf["channel"], sf["sftype"], sf["order"], sf["k_coeff"],
        sf["nw_coeff"], sf["k_res"], sf["k_res4"], sf["nw_res"],
        coeff_words, ctypes.byref(ct), res_words, ctypes.byref(rt),
    )
    if end < 0:
        raise ValueError(f"container structure error at byte {-end - 1}")
    sf["n_samples"] = n_samples
    sf["coeff_words"] = coeff_words[: ct.value].copy()
    sf["res_words"] = res_words[: rt.value].copy()
    return sf, int(end)
