"""File-level encode/decode — numpy oracle (executable spec, FORMAT.md).

Capability parity target: upstream:src/encoder.cpp, decoder.cpp
(sela::Encoder/Decoder; sahaRatul/sela, path-level cite — mount empty,
SURVEY.md SS2). The reference fans frames out over std::thread; the oracle is
deliberately sequential and scalar-clear — throughput comes from the device
pipeline in sela_tpu_torch.codec, which must match this output bit-exactly on
the decode side (round-trip exact; see FORMAT.md "Design invariant").
"""
from __future__ import annotations

import numpy as np

from ..format import FRAME_SIZE
from . import container, frame
from .wav import WavData


def encode_wav(w: WavData, frame_size: int = FRAME_SIZE,
               profile=None, tags: dict | None = None) -> bytes:
    """profile: optional object with BitstreamProfile's fields and validate()
    (frame_size, max_order, rice_k_max, mid_side, residue_partition;
    defaults = v1).
    tags: optional metadata dict appended as a tags trailer (FORMAT.md §Tags).

    Mid/side is disabled for 32-bit PCM regardless of profile (FORMAT.md:
    "For 32-bit PCM the encoder MUST use type 0 only" — the side channel
    would exceed int32).
    """
    n = w.n_samples
    if n == 0:
        raise ValueError("empty audio")
    max_order, rice_k_max, allow_ms, partition = 32, 30, True, 1
    if profile is not None:
        profile.validate()
        frame_size = profile.frame_size
        max_order = profile.max_order
        rice_k_max = profile.rice_k_max
        allow_ms = profile.mid_side != "off"
        partition = profile.residue_partition
    allow_ms = allow_ms and w.bits_per_sample <= 24
    frames = []
    for start in range(0, n, frame_size):
        stop = min(start + frame_size, n)
        chans = [c[start:stop] for c in w.channels]
        subframes = frame.encode_frame(chans, max_order, rice_k_max, allow_ms,
                                       partition)
        frames.append(container.serialize_frame(subframes, stop - start))
    header = container.SelaHeader(
        w.sample_rate, w.bits_per_sample, w.n_channels, len(frames)
    )
    buf = container.serialize_file(header, frames)
    if tags:
        buf += container.serialize_tags(tags)
    return buf


def decode_sela(buf: bytes) -> WavData:
    header = container.parse_header(buf)
    pos = container.HEADER_SIZE
    chunks: list[list[np.ndarray]] = []
    for _ in range(header.num_frames):
        subframes, n_samples, pos = container.parse_frame(buf, pos, header.channels)
        chunks.append(frame.decode_frame(subframes, header.channels))
    container.parse_trailer(buf, pos)  # metadata passthrough; junk raises
    channels = [
        np.concatenate([c[ch] for c in chunks]) if chunks else np.zeros(0, np.int32)
        for ch in range(header.channels)
    ]
    return WavData(header.sample_rate, header.bits_per_sample, channels)
