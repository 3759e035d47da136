"""ctypes bindings for the native Rice bitstream library (bitio.cpp).

The port's copy of sela_tpu/native/bitio.py: the single-pass frame scan
and the threaded block unpacker (decode), the threaded block packer and the
frame emitter (encode), and the block-list API over the packer and unpacker
(utils/bitpack.py). The library is built with g++ from this directory's
bitio.cpp at first use into the port's build directory (utils/build.py); a
failed build raises — the codec has no numpy packer to switch to.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..format import RESIDUE_PARTS, RICE_PARTITION_MARKER
from ..utils.build import build_library
from ..utils.metrics import NULL_METRICS

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
    # the last argument of the two pack passes: int64[3] worker figures
    # (parallel_for in bitio.cpp), or None
    lib.rice_block_words.argtypes = [
        i32p, i64p, i32p, i32p, i32p, ctypes.c_int64, i64p, ctypes.c_void_p,
    ]
    lib.rice_block_words.restype = None
    lib.rice_pack_blocks.argtypes = [
        i32p, i64p, i32p, i32p, i32p, i64p, ctypes.c_int64, u32p,
        ctypes.c_void_p,
    ]
    lib.rice_pack_blocks.restype = None
    lib.sela_emit_frames.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        u32p, u32p, u8p,
    ]
    lib.sela_emit_frames.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ks4(ks4, n: int) -> np.ndarray:
    """Packed sub-ks (k0 | k1 << 8 | ...), zeros when none is partitioned."""
    if ks4 is None:
        return np.zeros(n, np.int32)
    return np.ascontiguousarray(ks4, dtype=np.int32)


def pack_blocks_flat(values: np.ndarray, offs: np.ndarray, counts: np.ndarray,
                     ks: np.ndarray, ks4: np.ndarray | None = None,
                     metrics=None):
    """Rice-pack blocks: block i = values[offs[i] : offs[i] + counts[i]]
    with parameter ks[i] (32 = partition marker, sub-ks byte-packed in
    ks4[i]). Returns (words uint32 concatenated, word count of each block
    int64).

    metrics: optional utils.metrics.Metrics sink: stages "rice_count" and
    "rice_pack" around the two native passes, and their worker threads'
    summed wall and on-CPU seconds as "bitio_workers" and
    "bitio_workers_on_cpu" (n: workers run)."""
    lib = load()
    m = metrics or NULL_METRICS
    n = len(counts)
    values = np.ascontiguousarray(values, dtype=np.int32)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    k4 = _ks4(ks4, n)
    if not (len(offs) == len(ks) == len(k4) == n):
        raise ValueError("pack_blocks_flat: per-block arrays differ in length")
    if n and int((offs + counts).max()) > len(values):
        raise ValueError("pack_blocks_flat: block values out of range")
    stats = None if m is NULL_METRICS else np.zeros(3, np.int64)
    stats_p = None if stats is None else stats.ctypes.data
    word_counts = np.zeros(n, np.int64)
    with m.stage("rice_count"):
        lib.rice_block_words(values, offs, counts, ks, k4, n, word_counts,
                             stats_p)
    word_offs = np.zeros(n, np.int64)
    np.cumsum(word_counts[:-1], out=word_offs[1:])
    out = np.zeros(int(word_counts.sum()), np.uint32)
    with m.stage("rice_pack"):
        lib.rice_pack_blocks(values, offs, counts, ks, k4, word_offs, n, out,
                             stats_p)
    if stats is not None:
        workers, wall_ns, cpu_ns = (int(v) for v in stats)
        m.add_span("bitio_workers", wall_ns / 1e9, n=workers)
        m.add_span("bitio_workers_on_cpu", cpu_ns / 1e9, n=workers)
    return out, word_counts


def frames_size(num_frames: int, sf_kr: np.ndarray, sf_nwc: np.ndarray,
                sf_nwr: np.ndarray) -> int:
    """Bytes emit_frames writes for num_frames frames whose subframes have
    residue parameters sf_kr and coefficient / residue word counts sf_nwc
    / sf_nwr (FORMAT.md frame layout)."""
    n_part = int((np.asarray(sf_kr) == RICE_PARTITION_MARKER).sum())
    return (6 * num_frames + 11 * len(sf_kr) + RESIDUE_PARTS * n_part
            + 4 * int(np.sum(sf_nwc, dtype=np.int64)
                      + np.sum(sf_nwr, dtype=np.int64)))


def emit_frames(num_frames: int, channels: int, sync: int,
                n_samples: np.ndarray, sf_channel: np.ndarray,
                sf_type: np.ndarray, sf_order: np.ndarray, sf_kc: np.ndarray,
                sf_nwc: np.ndarray, sf_kr: np.ndarray, sf_nwr: np.ndarray,
                coeff_words: np.ndarray, res_words: np.ndarray,
                sf_kr4: np.ndarray | None = None, out: np.ndarray | None = None):
    """Serialize frames (FORMAT.md frame layout); the exact inverse of
    scan_frames. Subframe arrays are in emit order (frame-major).

    out: None, and the frames come back as bytes; or a C-contiguous 1-D
    uint8 array, into whose first bytes they are written, and their count
    comes back. An `out` shorter than the frames raises ValueError before
    any byte is written (the native emit checks no bound)."""
    lib = load()
    a32 = lambda a: np.ascontiguousarray(a, dtype=np.int32)   # noqa: E731
    kr = a32(sf_kr)
    kr4 = _ks4(sf_kr4, len(kr))
    nwc, nwr = a32(sf_nwc), a32(sf_nwr)
    coeff_words = np.ascontiguousarray(coeff_words, np.uint32)
    res_words = np.ascontiguousarray(res_words, np.uint32)
    n_sub = num_frames * channels
    per_sub = (n_samples, sf_channel, sf_type, sf_order, sf_kc, nwc, kr, kr4,
               nwr)
    if len(n_samples) != num_frames or any(len(a) != n_sub for a in per_sub[1:]):
        raise ValueError("emit_frames: per-frame or per-subframe arrays have "
                         "the wrong length")
    if (int(nwc.astype(np.int64).sum()) != len(coeff_words)
            or int(nwr.astype(np.int64).sum()) != len(res_words)):
        raise ValueError("emit_frames: word counts do not match the words")
    total = frames_size(num_frames, kr, nwc, nwr)
    dest = np.empty(total, np.uint8) if out is None else out
    if len(dest) < total:
        raise ValueError(f"emit_frames: out holds {len(dest)} bytes of the "
                         f"frames' {total}")
    written = lib.sela_emit_frames(
        num_frames, channels, sync, a32(n_samples), a32(sf_channel),
        a32(sf_type), a32(sf_order), a32(sf_kc), nwc, kr, kr4, nwr,
        coeff_words, res_words, dest)
    if written != total:
        raise RuntimeError(f"emit_frames wrote {written} of {total} bytes")
    return dest.tobytes() if out is None else total


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
    k4 = _ks4(ks4, n)
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


def _split_ks(klist) -> tuple[np.ndarray, np.ndarray]:
    """Per-block k entries -> (ks, ks4) int32: an int is a plain block's k; a
    sequence is a partitioned block's sub-ks, which becomes
    RICE_PARTITION_MARKER in ks and the sub-ks byte-packed in ks4."""
    ks = np.zeros(len(klist), np.int32)
    ks4 = np.zeros(len(klist), np.int32)
    for i, k in enumerate(klist):
        if isinstance(k, (list, tuple)) or np.ndim(k) > 0:
            ks[i] = RICE_PARTITION_MARKER
            ks4[i] = sum(int(sk) << (8 * q) for q, sk in enumerate(k))
        else:
            ks[i] = int(k)
    return ks, ks4


def _split(flat: np.ndarray, counts) -> list[np.ndarray]:
    """Concatenated blocks -> one copy a block."""
    ends = np.cumsum(np.asarray(counts, np.int64))
    return [flat[e - c : e].copy() for e, c in zip(ends, counts)]


def pack_blocks(blocks: list[tuple[np.ndarray, object]]) -> list[np.ndarray]:
    """List API over pack_blocks_flat: [(int32 values, k)] -> one uint32 word
    array a block. k is an int (a plain block) or a sequence of sub-ks (a
    partitioned block, FORMAT.md §Partitioned residues)."""
    if not blocks:
        return []
    counts = np.array([len(v) for v, _ in blocks], np.int32)
    ks, ks4 = _split_ks([k for _, k in blocks])
    offs = np.zeros(len(blocks), np.int64)
    np.cumsum(counts[:-1].astype(np.int64), out=offs[1:])
    values = np.concatenate([np.asarray(v, np.int32).reshape(-1)
                             for v, _ in blocks])
    words, word_counts = pack_blocks_flat(values, offs, counts, ks, ks4)
    return _split(words, word_counts)


def unpack_blocks(blocks: list[tuple[np.ndarray, int, object]]) -> list[np.ndarray]:
    """List API over unpack_blocks_flat: [(uint32 words, count, k)] -> one
    int32 value array a block; k as in pack_blocks."""
    if not blocks:
        return []
    word_counts = np.array([len(w) for w, _, _ in blocks], np.int32)
    counts = np.array([c for _, c, _ in blocks], np.int32)
    ks, ks4 = _split_ks([k for _, _, k in blocks])
    word_offs = np.zeros(len(blocks), np.int64)
    np.cumsum(word_counts[:-1].astype(np.int64), out=word_offs[1:])
    words = np.concatenate([np.asarray(w, np.uint32).reshape(-1)
                            for w, _, _ in blocks])
    return _split(unpack_blocks_flat(words, word_offs, word_counts, counts, ks,
                                     ks4), counts)


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
    # a frame's words come from its bytes, so the rest of the buffer bounds
    # them; np.empty leaves the pages the scan does not write untouched, so
    # a scan of a few frames of a long file costs its frames, not the file
    cap = max((len(buf) - pos) // 4 + 1, 1)
    coeff_words = np.empty(cap, np.uint32)
    res_words = np.empty(cap, np.uint32)
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
