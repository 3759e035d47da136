"""RIFF/WAVE PCM reader/writer (8/16/24/32-bit integer) — host I/O.

Capability parity target: upstream:src/file/wav_file.cpp (sahaRatul/sela,
path-level cite — mount empty, SURVEY.md SS2). Internally all samples are
int32 per channel; 8-bit WAV is unsigned and mapped via s - 128.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


class WavError(ValueError):
    pass


@dataclass
class WavData:
    sample_rate: int
    bits_per_sample: int
    channels: list[np.ndarray]  # each int32 [n_samples]

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def n_samples(self) -> int:
        return len(self.channels[0]) if self.channels else 0


def _decode_pcm(data: bytes, bps: int, nch: int) -> list[np.ndarray]:
    if bps == 8:
        flat = np.frombuffer(data, dtype=np.uint8).astype(np.int32) - 128
    elif bps == 16:
        flat = np.frombuffer(data, dtype="<i2").astype(np.int32)
    elif bps == 24:
        raw = np.frombuffer(data, dtype=np.uint8)
        raw = raw[: len(raw) // 3 * 3].reshape(-1, 3).astype(np.uint32)
        u = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
        flat = u.astype(np.int32)
        flat = np.where(flat >= 1 << 23, flat - (1 << 24), flat)
    elif bps == 32:
        flat = np.frombuffer(data, dtype="<i4").astype(np.int32)
    else:
        raise WavError(f"unsupported bits per sample: {bps}")
    n = len(flat) // nch * nch
    frames = flat[:n].reshape(-1, nch)
    return [np.ascontiguousarray(frames[:, c]) for c in range(nch)]


def _encode_pcm(channels: list[np.ndarray], bps: int) -> bytes:
    inter = np.stack([np.asarray(c, dtype=np.int32) for c in channels], axis=1).ravel()
    if bps == 8:
        return (inter + 128).astype(np.uint8).tobytes()
    if bps == 16:
        return inter.astype("<i2").tobytes()
    if bps == 24:
        u = inter.astype(np.int64) & 0xFFFFFF
        out = np.empty((len(u), 3), dtype=np.uint8)
        out[:, 0] = u & 0xFF
        out[:, 1] = (u >> 8) & 0xFF
        out[:, 2] = (u >> 16) & 0xFF
        return out.tobytes()
    if bps == 32:
        return inter.astype("<i4").tobytes()
    raise WavError(f"unsupported bits per sample: {bps}")


def read_wav_bytes(buf: bytes) -> WavData:
    if len(buf) < 12 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos : pos + 4]
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        body = buf[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or data is None:
        raise WavError("missing fmt/data chunk")
    tag, nch, rate, _, _, bps = struct.unpack_from("<HHIIHH", fmt, 0)
    if tag not in (1, 0xFFFE):  # PCM (or extensible wrapping PCM)
        raise WavError(f"unsupported WAV format tag: {tag}")
    if nch == 0:
        raise WavError("zero channels")
    return WavData(rate, bps, _decode_pcm(data, bps, nch))


def read_wav(path: str) -> WavData:
    with open(path, "rb") as f:
        return read_wav_bytes(f.read())


def write_wav_bytes(w: WavData) -> bytes:
    payload = _encode_pcm(w.channels, w.bits_per_sample)
    nch = w.n_channels
    block = nch * w.bits_per_sample // 8
    fmt = struct.pack(
        "<HHIIHH", 1, nch, w.sample_rate, w.sample_rate * block, block,
        w.bits_per_sample,
    )
    chunks = b"".join(
        [
            b"fmt ", struct.pack("<I", len(fmt)), fmt,
            b"data", struct.pack("<I", len(payload)), payload,
        ]
    )
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def write_wav(path: str, w: WavData) -> None:
    with open(path, "wb") as f:
        f.write(write_wav_bytes(w))
