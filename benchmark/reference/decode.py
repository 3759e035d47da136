"""Plain numpy decoder of the `.sela` bitstream, FORMAT.md v1 and v2.

A frozen copy of the format's decode side, written from FORMAT.md alone and
vectorised over frames and rows: the container walk is a Python loop over
subframe headers; the Rice decode advances every block by one value a step;
the integer Levinson runs one order a step over every row; the IIR runs one
sample a step over every row. It imports numpy and the standard library
only, and is strict where the format is: a stream it refuses raises
StreamError.

`decode(buf, iir_dtype=np.float32)` is the benchmark's control: the same
decoder with the prediction sum taken in float32, a precision below the
format's int64, which breaks the lossless guarantee.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"SeLa"
SYNC = 0xAA55FF00
FRAME_SIZE = 2048
MAX_ORDER = 32
REF_Q = 20
RICE_K_ESCAPE = 31
PARTITION_MARKER = 32
PARTS = 4
Q_LO, Q_HI = -64, 63
COEFF_SAT = 1 << 23
SF_DIRECT, SF_MID, SF_SIDE = 0, 1, 2
U32 = np.uint64(0xFFFFFFFF)

_HEADER = struct.Struct("<4sIHBI")
_FRAME = struct.Struct("<IH")
_SUB = struct.Struct("<BBBBH")
_U32 = struct.Struct("<I")


class StreamError(ValueError):
    """The stream breaks FORMAT.md."""


def _walk(buf: bytes, max_frames: int | None):
    """The container's header and every subframe's fields, in file order,
    with each block's words gathered into one array a kind: of every frame,
    or of the first max_frames."""
    if len(buf) < _HEADER.size:
        raise StreamError("truncated header")
    magic, rate, bits, C, F = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise StreamError("bad magic")
    if C == 0:
        raise StreamError("zero channels")
    whole = max_frames is None or max_frames >= F
    F = F if whole else max_frames
    rows = F * C
    n = np.zeros(F, np.int64)
    fields = np.zeros((rows, 5), np.int64)   # channel, type, order, kc, nwc
    kres = np.zeros((rows, PARTS), np.int64)
    nwr = np.zeros(rows, np.int64)
    cw_at, rw_at = [], []
    mv = memoryview(buf)
    pos, size, r = _HEADER.size, len(buf), 0
    for f in range(F):
        if pos + _FRAME.size > size:
            raise StreamError("truncated frame header")
        sync, n[f] = _FRAME.unpack_from(buf, pos)
        if sync != SYNC:
            raise StreamError(f"bad sync in frame {f}")
        if not 1 <= n[f] <= FRAME_SIZE:
            raise StreamError(f"frame {f} holds {n[f]} samples")
        pos += _FRAME.size
        for _ in range(C):
            if pos + _SUB.size > size:
                raise StreamError("truncated subframe header")
            fields[r] = _SUB.unpack_from(buf, pos)
            pos += _SUB.size
            cw_at.append(mv[pos:pos + 4 * int(fields[r, 4])])
            pos += 4 * int(fields[r, 4])
            if pos + 5 > size:
                raise StreamError("truncated residue header")
            k = buf[pos]
            if k == PARTITION_MARKER:
                if pos + 1 + PARTS + 4 > size:
                    raise StreamError("truncated partitioned residue header")
                kres[r] = tuple(buf[pos + 1:pos + 1 + PARTS])
                pos += 1 + PARTS
            else:
                kres[r] = k
                pos += 1
            (nwr[r],) = _U32.unpack_from(buf, pos)
            pos += 4
            rw_at.append(mv[pos:pos + 4 * int(nwr[r])])
            pos += 4 * int(nwr[r])
            if pos > size:
                raise StreamError("truncated block")
            r += 1
    if whole and pos != size:
        raise StreamError(f"{size - pos} bytes after the last frame")
    if np.any(fields[:, 2] > MAX_ORDER):
        raise StreamError("LPC order out of range")
    if np.any(fields[:, 3] > RICE_K_ESCAPE) or np.any(kres > RICE_K_ESCAPE):
        raise StreamError("rice k out of range")
    cw = np.frombuffer(b"".join(cw_at), "<u4")
    rw = np.frombuffer(b"".join(rw_at), "<u4")
    return (rate, bits, C, F), n, fields, kres, nwr, cw, rw


def _check_layout(ch: np.ndarray, st: np.ndarray, C: int) -> np.ndarray:
    """Each frame's channel bytes are a permutation of 0..C-1 and its types
    pair MID at even c with SIDE at c+1; returns the types by channel."""
    F = len(ch)
    if np.any(np.sort(ch, axis=1) != np.arange(C)[None, :]):
        raise StreamError("channel bytes are not a permutation")
    if np.any((st < SF_DIRECT) | (st > SF_SIDE)):
        raise StreamError("bad subframe type")
    t = np.zeros((F, C), np.int64)
    t[np.arange(F)[:, None], ch] = st
    mid, side = t == SF_MID, t == SF_SIDE
    want_side = np.zeros_like(side)
    want_side[:, 1::2] = mid[:, 0::2][:, :C // 2]
    if (np.any(side != want_side) or np.any(mid[:, 1::2])
            or (C % 2 == 1 and np.any(mid[:, C - 1]))):
        raise StreamError("MID/SIDE subframes do not pair")
    return t


def _read32(w64: np.ndarray, p: np.ndarray) -> np.ndarray:
    """The 32 stream bits from bit p on, as uint64; w64[j] holds words j
    and j + 1 (MSB-first words)."""
    return ((w64[p >> 5] << (p & 31).astype(np.uint64)) >> np.uint64(32)) & U32


def _leading_ones(t: np.ndarray) -> np.ndarray:
    """Leading one bits of 32-bit values below 2^32 - 1."""
    inv = (~t) & U32
    _, e = np.frexp(inv.astype(np.float64))
    return (32 - e).astype(np.int64)


def _rice(words: np.ndarray, start: np.ndarray, count: np.ndarray,
          ks: np.ndarray, nwords: np.ndarray) -> np.ndarray:
    """Rice-decode one block a row. start: each block's first bit in
    `words`; count: its values; ks [R, 4]: the k of each quarter of the
    block (all four the same for a plain block); nwords: its word count,
    which must be exactly what the values take. Returns [R, max count]
    int64 values, zero past each count."""
    R = len(count)
    width = int(count.max()) if R else 0
    out = np.zeros((R, width), np.int64)
    if width == 0:
        return out
    w = np.concatenate([words.astype(np.uint64), np.zeros(4, np.uint64)])
    w64 = (w[:-1] << np.uint64(32)) | w[1:]
    end_bit = 32 * len(words)
    p = start.astype(np.int64).copy()
    rows = np.arange(R)
    qb = np.stack([(q * count) // PARTS for q in range(1, PARTS)], 1)
    for i in range(width):
        live = count > i   # a row past its count reads on, but stays put
        k = ks[rows, (i >= qb).sum(1)]
        esc = k == RICE_K_ESCAPE
        t = _read32(w64, p)
        q = np.zeros(R, np.int64)
        pl = p
        run = (t == U32) & ~esc & live
        if run.any():   # unary runs of 32 or more ones
            pl = p.copy()
            while run.any():
                q[run] += 32
                pl[run] += 32
                if np.any(pl[run] >= end_bit):
                    raise StreamError("unary run past the end of the words")
                t[run] = _read32(w64, pl[run])
                run &= t == U32
        t = np.where(t == U32, 0, t)   # rows past their count, all ones
        ones = np.where(esc, 0, _leading_ones(t))
        q += ones
        p_rem = np.where(esc, pl, pl + ones + 1)
        kk = np.where(esc, 32, k)
        rem = _read32(w64, np.minimum(p_rem, end_bit)) >> (
            32 - kk).astype(np.uint64)
        u = np.where(esc, rem,
                     (q.astype(np.uint64) << k.astype(np.uint64)) | rem) & U32
        half = (u >> np.uint64(1)).astype(np.int64)
        out[:, i] = np.where(live, np.where(u & np.uint64(1), -half - 1, half),
                             0)
        p = np.where(live, p_rem + kk, p)
        if np.any(p > end_bit):
            raise StreamError("a value runs past the end of the words")
    used = p - start
    if np.any(used > 32 * nwords) or np.any(-(-used // 32) != nwords):
        raise StreamError("a block's word count is not its bits'")
    tail = (p & 31) != 0
    if tail.any():
        last = w[p[tail] >> 5] << (p[tail] & 31).astype(np.uint64)
        if np.any(last & U32):
            raise StreamError("nonzero bits after a block's last value")
    return out


def _lpc(q: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Quantized reflections [R, 32] -> Q20 direct-form coefficients
    [R, 32] by the integer Levinson, each row to its order."""
    R = len(order)
    g = q * 16384
    g[:, 0] = 128 * (q[:, 0] + 64) ** 2 - (1 << REF_Q)
    g[:, 1] = (1 << REF_Q) - 128 * (q[:, 1] + 64) ** 2
    a = np.zeros((R, MAX_ORDER), np.int64)
    half = 1 << (REF_Q - 1)
    for m in range(1, MAX_ORDER + 1):
        on = order >= m
        if not on.any():
            break
        k = g[:, m - 1]
        if m > 1:
            prev = a[:, :m - 1]
            step = np.clip(prev - ((k[:, None] * prev[:, ::-1] + half) >> REF_Q),
                           -COEFF_SAT, COEFF_SAT - 1)
            a[:, :m - 1] = np.where(on[:, None], step, prev)
        a[:, m - 1] = np.where(on, k, 0)
    return a


def _iir(e: np.ndarray, c: np.ndarray, dtype) -> np.ndarray:
    """x[n] = e[n] + rshift(sum_j c_j x[n-j], 20) over every row at once,
    history zero before the frame. The sum is taken in `dtype`."""
    R, S = e.shape
    x = np.zeros((R, MAX_ORDER + S), np.int64)
    crev = c[:, ::-1].astype(dtype)
    half = 1 << (REF_Q - 1)
    for n in range(S):
        hist = x[:, n:n + MAX_ORDER]
        if dtype == np.int64:
            acc = np.einsum("ij,ij->i", crev, hist)
            x[:, MAX_ORDER + n] = e[:, n] + ((acc + half) >> REF_Q)
        else:
            acc = np.einsum("ij,ij->i", crev, hist.astype(dtype))
            x[:, MAX_ORDER + n] = e[:, n] + np.floor(
                (acc + dtype(half)) / dtype(1 << REF_Q)).astype(np.int64)
    return x[:, MAX_ORDER:]


def decode(buf: bytes, iir_dtype=np.int64, max_frames: int | None = None):
    """(sample_rate, bits_per_sample, channels) of a `.sela` stream, each
    channel an int32 array: of the whole stream, or of its first max_frames
    frames. Raises StreamError on a stream that breaks FORMAT.md (a tags
    trailer included: the benchmark writes none)."""
    (rate, bits, C, F), n, fields, kres, nwr, cw, rw = _walk(
        buf, max_frames)
    R = F * C
    ch, st, order, kc, nwc = (fields[:, i] for i in range(5))
    types = _check_layout(ch.reshape(F, C), st.reshape(F, C), C)
    counts = np.repeat(n, C)
    cw_start = 32 * np.concatenate([[0], np.cumsum(nwc)[:-1]])
    rw_start = 32 * np.concatenate([[0], np.cumsum(nwr)[:-1]])
    q = np.zeros((R, MAX_ORDER), np.int64)
    qv = _rice(cw, cw_start, order, np.repeat(kc[:, None], PARTS, 1), nwc)
    q[:, :qv.shape[1]] = qv
    if np.any((q < Q_LO) | (q > Q_HI)):
        raise StreamError("quantized coefficient out of range")
    e = np.zeros((R, FRAME_SIZE), np.int64)
    ev = _rice(rw, rw_start, counts, kres, nwr)
    e[:, :ev.shape[1]] = ev
    x = _iir(e, _lpc(q, order), iir_dtype).astype(np.int32)
    dense = np.zeros((F, C, FRAME_SIZE), np.int32)
    dense[np.repeat(np.arange(F), C), ch] = x
    for c in range(0, C - 1, 2):   # inverse mid/side where the frame has it
        ms = types[:, c] == SF_MID
        mid = dense[ms, c].astype(np.int64)
        side = dense[ms, c + 1].astype(np.int64)
        left = mid + ((side + (side & 1)) >> 1)
        dense[ms, c] = left.astype(np.int32)
        dense[ms, c + 1] = (left - side).astype(np.int32)
    valid = np.arange(FRAME_SIZE)[None, :] < n[:, None]
    return rate, bits, [dense[:, c, :][valid] for c in range(C)]
