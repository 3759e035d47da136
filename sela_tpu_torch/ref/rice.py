"""Rice/Golomb entropy coder — numpy oracle (normative, see FORMAT.md SSRice).

Capability parity target: upstream:src/rice/rice_encoder.cpp /
rice_decoder.cpp (sahaRatul/sela, path-level cite — mount empty, SURVEY.md SS2).

Bit conventions (frozen):
  * zigzag: u = (v << 1) ^ (v >> 31) in u32 (INT_MIN wraps correctly)
  * per value, k <= 30: (u >> k) one-bits, a zero bit, low k bits of u MSB-first
  * k == 31 (escape): all 32 bits of u MSB-first, no unary part
  * bit i of the stream is bit 31 - (i % 32) of u32 word i // 32
"""
from __future__ import annotations

import numpy as np

from ..format import RICE_K_ESCAPE, RICE_K_MAX

U32 = 0xFFFFFFFF


def zigzag(v: np.ndarray) -> np.ndarray:
    """int32 array -> uint32 array (as uint64 for safe arithmetic)."""
    vi = np.asarray(v, dtype=np.int64)
    return (((vi << 1) ^ (vi >> 63)) & U32).astype(np.uint64)


def unzigzag(u: np.ndarray) -> np.ndarray:
    """uint32-valued array -> int32 array."""
    u = np.asarray(u, dtype=np.uint64)
    half = (u >> np.uint64(1)).astype(np.uint32)
    odd = (u & np.uint64(1)).astype(bool)
    return np.where(odd, ~half, half).astype(np.uint32).view(np.int32)


def optimal_k(u: np.ndarray, k_max: int = RICE_K_MAX) -> int:
    """Minimize C(k) = sum(u >> k) + n*(k+1) over k in [0, k_max].

    Returns RICE_K_ESCAPE when even the best Rice cost exceeds verbatim
    storage (32 bits/value).
    """
    n = len(u)
    if n == 0:
        return 0
    u = np.asarray(u, dtype=np.uint64)
    ks = np.arange(k_max + 1, dtype=np.uint64)
    costs = (u[None, :] >> ks[:, None]).sum(axis=1) + n * (ks + 1)
    best = int(np.argmin(costs))
    if costs[best] > 32 * n:
        return RICE_K_ESCAPE
    return best


def bit_lengths(u: np.ndarray, k: int) -> np.ndarray:
    u = np.asarray(u, dtype=np.uint64)
    if k == RICE_K_ESCAPE:
        return np.full(len(u), 32, dtype=np.int64)
    return ((u >> np.uint64(k)) + 1 + k).astype(np.int64)


def _pack_bits(u: np.ndarray, kv: np.ndarray) -> np.ndarray:
    """Core packer: zigzag values u with PER-VALUE parameter kv -> u32 words.

    Bit layout per value is the normative one (unary quotient + stop + k low
    bits; k == 31 -> 32 verbatim bits). Values with different k pack
    bit-contiguously — this is what makes partitioned residue blocks
    (FORMAT.md §Partitioned residues) byte-free at sub-block boundaries.
    """
    n = len(u)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    kv = np.asarray(kv, dtype=np.int64)
    esc = kv == RICE_K_ESCAPE
    # keep lens/offs integral: a uint64 >> int64 mix would promote to float64
    # (exact only below 2^53 — a fragile implicit bound in normative code)
    lens = np.where(
        esc,
        np.int64(32),
        (u >> np.minimum(kv, 31).astype(np.uint64)).astype(np.int64) + 1 + kv,
    )
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(offs[-1])
    if total > (1 << 28):
        # only reachable by FORCING k far below optimal (optimal-k planning
        # escapes to verbatim at 32 bits/value); the difference-array packer
        # below allocates O(total bits), so refuse instead of swapping
        raise ValueError(
            f"forced k yields {total} bits for {n} values — "
            "use optimal k (escape caps the stream at 32 bits/value)"
        )
    nbits_padded = -(-total // 32) * 32
    bits = np.zeros(nbits_padded, dtype=np.uint8)

    q = np.where(esc, 0, (u >> kv.astype(np.uint64)).astype(np.int64))
    # unary run of q ones starting at offs[i]: disjoint ranges via
    # difference-array + cumsum (escape values have q = 0: no unary part)
    delta = np.zeros(nbits_padded + 1, dtype=np.int64)
    starts = offs[:-1]
    np.add.at(delta, starts, 1)
    np.add.at(delta, starts + q, -1)
    bits |= (np.cumsum(delta[:-1]) > 0).astype(np.uint8)

    # remainder bits: rem_bits = kv (or 32 for escape), stop bit skipped
    # for escape. Grouped by distinct k to stay vectorized.
    for k in np.unique(kv):
        sel = kv == k
        if k == RICE_K_ESCAPE:
            rem_bits, stop = 32, 0
        else:
            rem_bits, stop = int(k), 1
        if rem_bits == 0:
            continue
        pos = (offs[:-1][sel] + q[sel] + stop)[:, None] + np.arange(rem_bits)
        shifts = np.uint64(rem_bits - 1) - np.arange(rem_bits, dtype=np.uint64)
        vals = ((u[sel][:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
        bits[pos.ravel()] = vals.ravel()

    packed = np.packbits(bits)  # MSB-first bytes
    return packed.view(">u4").astype(np.uint32)


def encode(values: np.ndarray, k: int | None = None,
           k_max: int = RICE_K_MAX) -> tuple[int, np.ndarray]:
    """Encode int32 values; returns (k, uint32 words)."""
    values = np.asarray(values, dtype=np.int32)
    u = zigzag(values)
    if k is None:
        k = optimal_k(u, k_max)
    n = len(u)
    if n == 0:
        return k, np.zeros(0, dtype=np.uint32)
    return k, _pack_bits(u, np.full(n, k, np.int64))


def partition_bounds(n: int, n_parts: int) -> list[tuple[int, int]]:
    """Sub-block [lo, hi) bounds: part q holds [q*n//P, (q+1)*n//P). NORMATIVE."""
    return [(q * n // n_parts, (q + 1) * n // n_parts) for q in range(n_parts)]


def encode_partitioned(values: np.ndarray, n_parts: int = 4,
                       k_max: int = RICE_K_MAX) -> tuple[list[int], np.ndarray]:
    """Partitioned residue coding (FORMAT.md §Partitioned residues):
    values split into n_parts sub-blocks, each with its own optimal k,
    packed bit-contiguously. Returns (ks list, uint32 words)."""
    values = np.asarray(values, dtype=np.int32)
    u = zigzag(values)
    n = len(u)
    kv = np.zeros(n, np.int64)
    ks = []
    for lo, hi in partition_bounds(n, n_parts):
        k = optimal_k(u[lo:hi], k_max)
        ks.append(k)
        kv[lo:hi] = k
    words = _pack_bits(u, kv) if n else np.zeros(0, np.uint32)
    return ks, words


def encode_with_sub_ks(values: np.ndarray, ks) -> np.ndarray:
    """Pack `values` partitioned with GIVEN sub-block ks (host packing of a
    device-planned partitioned block). Returns uint32 words."""
    values = np.asarray(values, dtype=np.int32)
    u = zigzag(values)
    n = len(u)
    if n == 0:
        return np.zeros(0, np.uint32)
    kv = np.zeros(n, np.int64)
    for (lo, hi), k in zip(partition_bounds(n, len(ks)), ks):
        kv[lo:hi] = int(k)
    return _pack_bits(u, kv)


def partitioned_cost_bits(values: np.ndarray, n_parts: int = 4,
                          k_max: int = RICE_K_MAX) -> tuple[list[int], int]:
    """(ks, total payload bits) for partitioned coding of `values`."""
    u = zigzag(np.asarray(values, dtype=np.int32))
    ks, bits = [], 0
    for lo, hi in partition_bounds(len(u), n_parts):
        k = optimal_k(u[lo:hi], k_max)
        ks.append(k)
        bits += int(bit_lengths(u[lo:hi], k).sum())
    return ks, bits


def words_to_bits(words: np.ndarray) -> np.ndarray:
    """uint32 words -> uint8 bit array (MSB-first per word)."""
    be = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).astype(">u4")
    return np.unpackbits(np.frombuffer(be.tobytes(), dtype=np.uint8))


def _decode_bits(bits: np.ndarray, zero_pos: np.ndarray, pos: int,
                 count: int, k: int) -> tuple[np.ndarray, int]:
    """Decode `count` zigzag values with parameter k starting at bit `pos`.

    Returns (u values, new bit position). Corrupted/truncated streams
    terminate at the bit-array end and pad with zeros (same semantics as the
    native BitReader: garbage in, bounded garbage out, never out-of-bounds).
    """
    u = np.zeros(count, dtype=np.uint64)
    nbits = len(bits)
    if k == RICE_K_ESCAPE:
        b = bits[pos : pos + count * 32]
        if len(b) < count * 32:
            b = np.concatenate([b, np.zeros(count * 32 - len(b), np.uint8)])
        b = b.reshape(count, 32).astype(np.uint64)
        shifts = np.uint64(31) - np.arange(32, dtype=np.uint64)
        u[:] = (b << shifts[None, :]).sum(axis=1)
        return u, pos + count * 32
    shifts = np.uint64(k - 1) - np.arange(k, dtype=np.uint64) if k else None
    for i in range(count):
        zi = np.searchsorted(zero_pos, pos, side="left")
        stop = int(zero_pos[zi]) if zi < len(zero_pos) else nbits
        q = max(stop - pos, 0)
        if k > 0:
            rem_bits = bits[stop + 1 : stop + 1 + k].astype(np.uint64)
            if len(rem_bits) < k:
                rem_bits = np.concatenate(
                    [rem_bits, np.zeros(k - len(rem_bits), np.uint64)]
                )
            rem = int((rem_bits << shifts).sum())
        else:
            rem = 0
        # uint32 wrap-around exactly like the native packer's 32-bit math
        u[i] = ((q << k) | rem) & U32
        pos = stop + 1 + k
    return u, pos


def decode(words: np.ndarray, count: int, k: int) -> np.ndarray:
    """Decode `count` int32 values from uint32 words with parameter k."""
    if count == 0:
        return np.zeros(0, dtype=np.int32)
    bits = words_to_bits(words)
    u, _ = _decode_bits(bits, np.flatnonzero(bits == 0), 0, count, k)
    return unzigzag(u)


def decode_partitioned(words: np.ndarray, count: int,
                       ks: list[int]) -> np.ndarray:
    """Inverse of encode_partitioned: sub-block q (bounds per
    partition_bounds) decoded with ks[q]; sub-blocks are bit-contiguous."""
    if count == 0:
        return np.zeros(0, dtype=np.int32)
    bits = words_to_bits(words)
    zero_pos = np.flatnonzero(bits == 0)
    out = np.zeros(count, dtype=np.uint64)
    pos = 0
    for (lo, hi), k in zip(partition_bounds(count, len(ks)), ks):
        out[lo:hi], pos = _decode_bits(bits, zero_pos, pos, hi - lo, k)
    return unzigzag(out)


def encoded_cost_bits(values: np.ndarray) -> tuple[int, int]:
    """(k, total bits) for the optimal encoding of `values`."""
    u = zigzag(np.asarray(values, dtype=np.int32))
    k = optimal_k(u)
    return k, int(bit_lengths(u, k).sum())
