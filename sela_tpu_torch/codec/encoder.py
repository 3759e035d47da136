"""Host-side encode orchestration: PCM -> device chunks -> .sela bytes.

Counterpart of sela_tpu/codec/encoder.py. The PCM is framed into [F, C, S]
chunks, each chunk is staged in pinned host buffers and copied to the
device without blocking, codec/pipeline.py::encode_step analyzes and
renders it there (K3, K4, K1, K5, K6), and the planning arrays and residues
come back without blocking into pinned buffers, behind one CUDA event a
chunk. The host Rice-packs chunk i with the native library (native/
bitio.cpp, built at first use; there is no numpy packer) while the card
encodes chunks i+1..i+3 (a PIPELINE-deep software pipeline), and the frames
are serialized in order.

≤16-bit PCM crosses to the device as int16, and its residues come back as
int16 with the chunk's per-frame fits16 flags: a chunk whose residues do
not all fit (rare) fetches its int32 residues after its event, so the
steady state never waits on the device mid-chunk. Wider PCM sends and
fetches int32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..format import FRAME_SIZE, MAX_ORDER, SYNC
from ..native import bitio
from ..ref import container
from ..ref.wav import WavData
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from .pipeline import encode_step

DEFAULT_CHUNK_FRAMES = 512
PIPELINE = 4   # device-encode chunks in flight while the host packs
# per-subframe planning columns fetched together, then the 32 coefficients
PLAN = ("order", "k_res", "k_res4", "k_coeff", "nw_res", "nw_coeff", "sftype")


def frame_batches(channels: list[np.ndarray], frame_size: int = FRAME_SIZE,
                  dtype=np.int32):
    """channels -> (x [F, C, S] zero-padded, n_valid [F] int32).

    x is a [F, C, S] view of one [C, F S] array of `dtype`."""
    n = len(channels[0])
    C = len(channels)
    F = -(-n // frame_size)
    flat = np.zeros((C, F * frame_size), dtype)
    for c, ch in enumerate(channels):
        flat[c, :n] = ch
    n_valid = np.full(F, frame_size, np.int32)
    if n % frame_size:
        n_valid[-1] = n % frame_size
    return flat.reshape(C, F, frame_size).transpose(1, 0, 2), n_valid


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1].astype(np.int64), out=out[1:])
    return out


def _pack_chunk(plan: np.ndarray, res: np.ndarray, nv: np.ndarray) -> bytes:
    """Rice-pack and serialize the frames of one chunk (native library).

    plan: [F, C, len(PLAN) + 32] int32 (PLAN columns, then qcoeffs);
    res: [F, C, S] residues; nv: [F] valid samples a frame."""
    F, C, S = res.shape
    cols = {k: np.ascontiguousarray(plan[:, :, i].reshape(-1))
            for i, k in enumerate(PLAN)}
    order = cols["order"]
    res_counts = np.repeat(nv, C)
    evals = res.reshape(F * C, S)[np.arange(S)[None, :] < res_counts[:, None]]
    res_words, res_wc = bitio.pack_blocks_flat(
        evals, _exclusive_cumsum(res_counts), res_counts, cols["k_res"],
        cols["k_res4"])
    qrows = plan[:, :, len(PLAN):].reshape(F * C, MAX_ORDER)
    qvals = qrows[np.arange(MAX_ORDER)[None, :] < order[:, None]]
    coeff_words, coeff_wc = bitio.pack_blocks_flat(
        qvals, _exclusive_cumsum(order), order, cols["k_coeff"])
    # the device planned every block's words from its bit counts (K5, K6);
    # the packer counts them again from the values: they must agree
    if not (np.array_equal(res_wc, cols["nw_res"])
            and np.array_equal(coeff_wc, cols["nw_coeff"])):
        raise RuntimeError("device Rice plan and host packer disagree on "
                           "block sizes")
    return bitio.emit_frames(
        F, C, SYNC, nv, np.tile(np.arange(C, dtype=np.int32), F),
        cols["sftype"], order, cols["k_coeff"], coeff_wc, cols["k_res"],
        res_wc, coeff_words, res_words, sf_kr4=cols["k_res4"])


class _Slot:
    """Host staging buffers of one in-flight chunk, pinned when the device
    is CUDA so that the copies run asynchronously."""

    def __init__(self, frames: int, C: int, S: int, wire, cuda: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        self.x = buf((frames, C, S), wire)
        self.nv = buf((frames,), torch.int32)
        self.plan = buf((frames, C, len(PLAN) + MAX_ORDER), torch.int32)
        self.fits16 = buf((frames,), torch.int32)
        self.res = buf((frames, C, S), wire)
        self.event = torch.cuda.Event() if cuda else None


def encode_wav(w: WavData, frame_size: int = FRAME_SIZE,
               chunk_frames: int = DEFAULT_CHUNK_FRAMES, profile=None,
               metrics=None, tags: dict | None = None, device=None) -> bytes:
    """Encode WavData to .sela bytes on `device` (default: the CUDA card).

    profile: optional config.BitstreamProfile (defaults = FORMAT.md v1;
    residue_partition=4 raises NotImplementedError until the K8 kernel is
    ported). device="cpu" runs the plain PyTorch versions of the kernels;
    with no device named and no CUDA available this raises. metrics:
    optional utils.metrics.Metrics sink (stages host_frame /
    device_dispatch / device_fetch / host_pack). tags: optional metadata
    appended as a tags trailer (FORMAT.md §Tags).
    """
    if w.n_samples == 0:
        raise ValueError("empty audio")
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    max_order, rice_k_max, allow_ms, partition = MAX_ORDER, None, True, 1
    ms_mode = "est"
    if profile is not None:
        profile.validate()
        frame_size = profile.frame_size
        max_order = profile.max_order
        rice_k_max = profile.rice_k_max
        allow_ms = profile.mid_side != "off"
        ms_mode = "exact" if profile.mid_side == "exact" else "est"
        partition = profile.residue_partition
    if partition != 1:
        raise NotImplementedError(
            "residue_partition=4 needs the quarter-counts kernel (K8), which "
            "the port does not have yet")
    allow_ms = allow_ms and w.bits_per_sample <= 24   # FORMAT.md: 32-bit is LR
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    m = metrics or NULL_METRICS
    wire16 = w.bits_per_sample <= 16
    wire = torch.int16 if wire16 else torch.int32

    with m.stage("host_frame"):
        x, n_valid = frame_batches(w.channels, frame_size,
                                   np.int16 if wire16 else np.int32)
    F, C, S = x.shape
    chunk_frames = min(chunk_frames, F)
    slots = [_Slot(chunk_frames, C, S, wire, cuda)
             for _ in range(min(PIPELINE, -(-F // chunk_frames)))]

    def dispatch(index: int, start: int):
        """Stage one chunk and enqueue its device encode and copies back."""
        slot = slots[index % len(slots)]
        stop = min(start + chunk_frames, F)
        fcount = stop - start
        with m.stage("host_frame"):
            slot.x.numpy()[:fcount] = x[start:stop]
            slot.nv.numpy()[:fcount] = n_valid[start:stop]
        with m.stage("device_dispatch"):
            out = encode_step(
                slot.x[:fcount].to(dev, non_blocking=True),
                slot.nv[:fcount].to(dev, non_blocking=True),
                allow_ms=allow_ms, max_order=max_order, rice_k_max=rice_k_max,
                ms_mode=ms_mode)
            plan = torch.cat([torch.stack([out[k] for k in PLAN], dim=-1),
                              out["qcoeffs"]], dim=-1)
            slot.plan[:fcount].copy_(plan, non_blocking=cuda)
            slot.fits16[:fcount].copy_(out["fits16"], non_blocking=cuda)
            slot.res[:fcount].copy_(out["res16"] if wire16 else out["residues"],
                                    non_blocking=cuda)
            if cuda:
                slot.event.record(torch.cuda.current_stream(dev))
        # the int32 residues stay on the device for a chunk whose int16
        # copy turns out not to hold them
        return slot, start, fcount, out["residues"] if wire16 else None

    frames: list[bytes] = []

    def collect(item):
        slot, start, fcount, res32 = item
        with m.stage("device_fetch"):
            if cuda:
                slot.event.synchronize()
            res = slot.res[:fcount].numpy()
            if wire16 and not slot.fits16[:fcount].numpy().all():
                res = res32.cpu().numpy()
        with m.stage("host_pack"):
            frames.append(_pack_chunk(slot.plan[:fcount].numpy(), res,
                                      n_valid[start:start + fcount]))
        m.count("frames", fcount)

    inflight = []
    for index, start in enumerate(range(0, F, chunk_frames)):
        inflight.append(dispatch(index, start))
        if len(inflight) >= len(slots):
            collect(inflight.pop(0))
    for item in inflight:
        collect(item)

    header = container.SelaHeader(w.sample_rate, w.bits_per_sample, C, F)
    buf = container.serialize_file(header, frames)
    if tags:
        buf += container.serialize_tags(tags)
    m.count("pcm_bytes", w.n_samples * w.n_channels * w.bits_per_sample // 8)
    m.count("coded_bytes", len(buf))
    return buf
