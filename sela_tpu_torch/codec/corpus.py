"""Corpus-level batch codec: many heterogeneous WAV files per device chunk.

Counterpart of sela_tpu/codec/corpus.py. The frames of all files of one
group (same channel count, same <=24-bit class: the same mid/side rule) run
one file after another through shared device chunks, so small files share
device batches instead of paying for a launch sequence each. encode_files
hands a group's files to encode_wav's chunk engine
(codec/encoder.py::encode_chunks: each chunk framed from the files'
channels straight into its pinned slot, the pipeline, the CUDA graph of a
full chunk, the card's Rice pack on v1) and emits each file's header and
frames, from the chunks that hold them, into one stream buffer
(encoder.StreamBuffer), where each file is one slice, so each file's
stream is byte-identical to its own encode_wav stream. decode_files runs decode_step chunks; it returns
int32 PCM at every bit depth, as sela_tpu's does, so each decoded file
equals the oracle's (but where a reconstruction leaves int32: both
packages wrap it to 32 bits) and, wherever its samples fit its declared bit
depth, its own decode_sela (which narrows <=16-bit output to int16 in both
packages).
"""
from __future__ import annotations

import numpy as np
import torch

from ..format import FRAME_SIZE, MAX_ORDER
from ..ref import container
from ..ref.wav import WavData
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from .decoder import merge_scans, scan, unpack
from .encoder import (DEFAULT_CHUNK_FRAMES, StreamBuffer, check_frame_size,
                      encode_chunks, frame_counts, stream_bound)
from .pipeline import decode_step


def _groups(keys) -> dict:
    """(channels, <=24-bit) -> indices of the files that share it."""
    groups: dict[tuple[int, bool], list[int]] = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    return groups


def encode_files(wavs: list[WavData], chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                 frame_size: int = FRAME_SIZE, device=None,
                 metrics=None) -> list[bytes]:
    """Encode WavData files to .sela bytes on `device` (default: the CUDA
    card), the files of a group sharing the chunks of encode_wav's engine;
    the default profile at `frame_size` samples a frame. Each file's stream
    is its encode_wav stream at that frame size. A group crosses to the
    device as int16 where every file of it is <=16-bit, as encode_wav's.

    device="cpu" runs the plain PyTorch versions of the kernels; with no
    device named and no CUDA available this raises. frame_size outside
    [32, FRAME_SIZE] raises (encoder.check_frame_size). metrics: optional
    utils.metrics.Metrics sink (encode_wav's stages and counters, and
    files, groups; utils/metrics.py).
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    check_frame_size(frame_size)
    for i, w in enumerate(wavs):
        if w.n_samples == 0:
            raise ValueError(f"file {i}: empty audio")
    dev = resolve_device(device)
    m = metrics or NULL_METRICS
    results: list[bytes | None] = [None] * len(wavs)
    groups = _groups((w.n_channels, w.bits_per_sample <= 24) for w in wavs)
    counts = {key: frame_counts([wavs[i].n_samples for i in idxs],
                                frame_size)[0]
              for key, idxs in groups.items()}
    # one stream buffer for the run, a group's files one after another in
    # it from offset 0
    stream = StreamBuffer(max((stream_bound(counts[key], key[0], frame_size,
                                            False) for key in groups),
                              default=0), m)
    for (C, allow_ms), idxs in groups.items():
        # encode_wav's wire rule, for the whole group
        wire = (torch.int16 if all(wavs[i].bits_per_sample <= 16
                                   for i in idxs) else torch.int32)
        bounds = np.cumsum([0, *counts[C, allow_ms]])
        spans = [[0, 0] for _ in idxs]   # each file's bytes in the buffer
        stream.pos = 0

        def emit(start, fcount, packed, nv):   # each file's frames in it
            for j, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
                a, b = max(lo, start), min(hi, start + fcount)
                if a < b:
                    if a == lo:   # the file's first frame: its header first
                        spans[j][0] = stream.pos
                        wav = wavs[idxs[j]]
                        stream.write(container.serialize_file(
                            container.SelaHeader(
                                wav.sample_rate, wav.bits_per_sample, C,
                                int(hi - lo)), []))
                    stream.frames(packed, nv, a - start, b - start)
                    spans[j][1] = stream.pos

        encode_chunks([wavs[i].channels for i in idxs], wire, frame_size,
                      dev, chunk_frames, dict(allow_ms=allow_ms), m, emit)
        for i, (a, b) in zip(idxs, spans):
            with m.stage("host_assemble"):
                results[i] = stream.take(a, b)
        m.count("groups")
    m.count("files", len(wavs))
    m.count("pcm_bytes", sum(w.n_samples * w.n_channels * w.bits_per_sample
                             // 8 for w in wavs))
    m.count("coded_bytes", sum(len(b) for b in results))
    return results  # type: ignore[return-value]


def decode_files(bufs: list[bytes], chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                 device=None) -> list[WavData]:
    """Decode .sela buffers on `device` (default: the CUDA card), the files
    of a group sharing device chunks.

    Every buffer is scanned and validated first (codec/decoder.py::scan, the
    trailer too), so damage anywhere raises ContainerError before any device
    work. device="cpu" runs the plain PyTorch versions of the kernels; with
    no device named and no CUDA available this raises.
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    dev = resolve_device(device)
    parsed = []
    for buf in bufs:
        h = container.parse_header(buf)
        sf, end = scan(buf, container.HEADER_SIZE, h.num_frames, h.channels)
        container.parse_trailer(buf, end)  # metadata passthrough; junk raises
        parsed.append((h, sf))

    results: list[WavData | None] = [None] * len(bufs)
    S = FRAME_SIZE
    groups = _groups((h.channels, h.bits_per_sample <= 24) for h, _ in parsed)
    for (C, _), idxs in groups.items():
        F_all = sum(parsed[i][0].num_frames for i in idxs)
        # every block of the group in one native unpack, range-checked
        # before the scatter
        sf = merge_scans([parsed[i][1] for i in idxs], C)
        rows, qrows, erows, fits16 = unpack(sf, 0, F_all * C, C)
        # int16 wire for the residue upload when the whole group fits; the
        # PCM comes back int32, as sela_tpu's decode_files returns it
        residues = np.zeros((F_all * C, S), np.int16 if fits16 else np.int32)
        qcoeffs = np.zeros((F_all * C, MAX_ORDER), np.int32)
        order = np.zeros(F_all * C, np.int32)
        sftype = np.zeros(F_all * C, np.int32)
        residues[rows], qcoeffs[rows] = erows, qrows
        order[rows], sftype[rows] = sf["order"], sf["sftype"]

        pcm = np.zeros((F_all, C, S), np.int32)
        for lo in range(0, F_all, chunk_frames):
            hi = min(lo + chunk_frames, F_all)

            def put(a: np.ndarray, *shape):
                return torch.from_numpy(a[lo * C : hi * C]).view(
                    hi - lo, C, *shape).to(dev)

            pcm[lo:hi] = decode_step(
                put(residues, S), put(qcoeffs, MAX_ORDER), put(order),
                put(sftype)).cpu().numpy()

        pos = 0
        for i in idxs:
            h = parsed[i][0]
            F, nv = h.num_frames, parsed[i][1]["n_samples"]
            valid = np.arange(S)[None, :] < nv[:, None]
            chans = [pcm[pos : pos + F, c][valid] for c in range(C)]
            results[i] = WavData(h.sample_rate, h.bits_per_sample, chans)
            pos += F
    return results  # type: ignore[return-value]
