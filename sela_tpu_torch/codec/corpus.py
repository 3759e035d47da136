"""Corpus-level batch codec: many heterogeneous WAV files per device chunk.

Counterpart of sela_tpu/codec/corpus.py. The frames of all files of one
group (same channel count, same <=24-bit class: the same mid/side rule) are
concatenated along the frame axis and run through the same encode_step /
decode_step chunks, so small files share device batches instead of paying
for a launch sequence each. Each file's stream is byte-identical to its own
encode_wav stream. decode_files returns int32 PCM at every bit depth, as
sela_tpu's does, so each decoded file equals the oracle's (but where a
reconstruction leaves int32: both packages wrap it to 32 bits) and, wherever
its samples fit its declared bit depth, its own decode_sela (which narrows
<=16-bit output to int16 in both packages).
"""
from __future__ import annotations

import numpy as np
import torch

from ..format import FRAME_SIZE, MAX_ORDER
from ..ref import container
from ..ref.wav import WavData
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from .decoder import DEFAULT_CHUNK_FRAMES, merge_scans, scan, unpack
from .encoder import (PLAN, check_frame_size, frame_batches, pack_frames,
                      serialize_frames)
from .pipeline import decode_step, encode_step


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
    card), the files of a group sharing device chunks; the default profile
    at `frame_size` samples a frame. Each file's stream is its encode_wav
    stream at that frame size.

    device="cpu" runs the plain PyTorch versions of the kernels; with no
    device named and no CUDA available this raises. frame_size outside
    [32, FRAME_SIZE] raises (encoder.check_frame_size). metrics: optional
    utils.metrics.Metrics sink (stages host_frame / device_dispatch /
    device_fetch / host_pack, and inside host_pack pack_gather /
    rice_count / rice_pack / emit; counters files, groups, chunks,
    int32_fetch, pack_blocks_host, pcm_bytes, coded_bytes;
    utils/metrics.py).
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
    for (C, allow_ms), idxs in groups.items():
        with m.stage("host_frame"):
            framed = [frame_batches(wavs[i].channels, frame_size)
                      for i in idxs]
            x_all = np.concatenate([x for x, _ in framed])
            nv_all = np.concatenate([nv for _, nv in framed])
        plans, residues = [], []
        for start in range(0, len(x_all), chunk_frames):
            stop = start + chunk_frames
            with m.stage("device_dispatch"):
                out = encode_step(torch.from_numpy(x_all[start:stop]).to(dev),
                                  torch.from_numpy(nv_all[start:stop]).to(dev),
                                  allow_ms=allow_ms)
                plan = torch.cat([torch.stack([out[k] for k in PLAN], dim=-1),
                                  out["qcoeffs"]], dim=-1)
            with m.stage("device_fetch"):
                plans.append(plan.cpu().numpy())
                # int16 wire for the residue fetch when every frame's fits
                wire16 = bool(out["fits16"].all())
                residues.append(
                    out["res16" if wire16 else "residues"].cpu().numpy())
            m.count("chunks")
            if not wire16:
                m.count("int32_fetch")
        # every block of the group in one native pack, then each file's
        # frames serialized from its range
        with m.stage("host_pack"):
            packed = pack_frames(
                np.concatenate(plans),
                np.concatenate([r.astype(np.int32, copy=False)
                                for r in residues]),
                nv_all, m)
            pos = 0
            for i, (x, _) in zip(idxs, framed):
                F = len(x)
                header = container.SelaHeader(wavs[i].sample_rate,
                                              wavs[i].bits_per_sample, C, F)
                frames = serialize_frames(packed, nv_all, pos, pos + F, m)
                results[i] = container.serialize_file(header, [frames])
                pos += F
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
