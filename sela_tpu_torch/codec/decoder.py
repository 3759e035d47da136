"""Host-side decode orchestration: container -> device chunks -> PCM.

Counterpart of sela_tpu/codec/decoder.py. The container is scanned and
Rice-unpacked on the host by the native library (native/bitio.cpp, built at
first use; there is no numpy unpacker to switch to), residues and
coefficients are scattered into dense [F, C, S] chunks in pinned host
buffers, and codec/pipeline.py::decode_step runs the integer Levinson, the
IIR synthesis and the inverse mid/side on the device. Host->device and
device->host copies are non-blocking and each chunk's completion is a CUDA
event, so the host unpack of the next chunks overlaps the device decode of
the earlier ones (a PIPELINE-deep software pipeline).
"""
from __future__ import annotations

import numpy as np
import torch

from ..errors import ContainerError
from ..format import (
    FRAME_SIZE,
    MAX_ORDER,
    RICE_K_ESCAPE,
    RICE_PARTITION_MARKER,
    SF_MID,
    SF_SIDE,
    SYNC,
)
from ..native import bitio
from ..ref import container
from ..ref import frame as frame_mod
from ..ref.wav import WavData
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from .pipeline import decode_step

DEFAULT_CHUNK_FRAMES = 512
PIPELINE = 4  # device-decode chunks in flight while the host unpacks ahead


def _validate_layout(sf: dict, F: int, C: int) -> None:
    """Vectorized form of ref.frame.validate_subframe_layout over all frames.

    Channel bytes must be a per-frame permutation of 0..C-1 (a duplicate
    would otherwise last-write-win in the dense scatter) and sftype pairing
    must be exactly the encoder's (MID at even c, SIDE at c+1)."""
    ch = sf["channel"].reshape(F, C)
    if np.any(np.sort(ch, axis=1) != np.arange(C, dtype=ch.dtype)[None, :]):
        raise ContainerError(
            "subframe channels are not a permutation of 0..channels-1"
        )
    st = np.zeros((F, C), np.int32)
    st[np.arange(F)[:, None], ch] = sf["sftype"].reshape(F, C)
    if np.any((st < 0) | (st > SF_SIDE)):
        raise ContainerError("bad subframe type")
    mid = st == SF_MID
    side = st == SF_SIDE
    exp_side = np.zeros_like(side)
    exp_side[:, 1::2] = mid[:, 0::2][:, : C // 2]
    if np.any(side != exp_side) or np.any(mid[:, 1::2]) or (
        C % 2 == 1 and np.any(mid[:, C - 1])
    ):
        raise ContainerError("inconsistent MID/SIDE subframe pairing")


def scan(buf: bytes, pos: int, num_frames: int, channels: int) -> tuple[dict, int]:
    """Native scan of `num_frames` frames from byte `pos`, validated: any
    structural fault, an LPC order over MAX_ORDER, a Rice k out of range or a
    bad subframe layout raises ContainerError. Returns (fields, end): the
    fields of bitio.scan_frames plus each block's word offsets (cw_offs,
    rw_offs: [F C + 1]) and res_counts (values a residue block), and the
    byte offset after the last frame."""
    try:
        sf, end = bitio.scan_frames(buf, pos, num_frames, channels, SYNC,
                                    FRAME_SIZE)
    except ValueError as e:
        raise ContainerError(str(e)) from None
    if np.any(sf["order"] > MAX_ORDER):
        raise ContainerError("LPC order out of range")
    # rice k beyond the escape code would drive the bit reader out of its
    # <=32-bit domain; k_res may also be the partition marker
    if np.any(sf["k_coeff"] > RICE_K_ESCAPE) or np.any(
        (sf["k_res"] > RICE_K_ESCAPE) & (sf["k_res"] != RICE_PARTITION_MARKER)
    ):
        raise ContainerError("rice k out of range")
    _validate_layout(sf, num_frames, channels)
    return _index(sf, channels), end


_DERIVED = ("res_counts", "cw_offs", "rw_offs")


def _index(sf: dict, channels: int) -> dict:
    """Add a scan's derived fields: values a residue block, block word
    offsets."""
    sf["res_counts"] = np.repeat(sf["n_samples"], channels)
    sf["cw_offs"] = _exclusive_cumsum(sf["nw_coeff"])
    sf["rw_offs"] = _exclusive_cumsum(sf["nw_res"])
    return sf


def merge_scans(scans: list[dict], channels: int) -> dict:
    """The scans of consecutive runs of frames (the files of a corpus group)
    as one scan, so that one unpack covers them all."""
    return _index({k: np.concatenate([sf[k] for sf in scans])
                   for k in scans[0] if k not in _DERIVED}, channels)


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a.astype(np.int64), out=out[1:])
    return out


def unpack(sf: dict, lo: int, hi: int, channels: int,
           metrics=NULL_METRICS):
    """Host-unpack the subframes [lo, hi) of a scan (whole frames): their
    dense rows in file order and where each goes. Returns (rows, qrows
    [n, 32], erows [n, S] int32, fits16): row i belongs at (frame, channel)
    row rows[i], counted from frame lo // channels; fits16 says every
    residue fits int16. The coefficients are range-checked
    (check_coeff_range) before any row is built. Each of bitio's two
    unpacks (coefficients, residues) is a `rice_unpack` span of
    `metrics`."""
    nwc = sf["nw_coeff"][lo:hi]
    nwr = sf["nw_res"][lo:hi]
    order = sf["order"][lo:hi]
    res_counts = sf["res_counts"][lo:hi]
    cw, rw = sf["cw_offs"], sf["rw_offs"]
    with metrics.stage("rice_unpack"):
        qvals = bitio.unpack_blocks_flat(
            sf["coeff_words"][cw[lo] : cw[hi]], _exclusive_cumsum(nwc)[:-1],
            nwc, order, sf["k_coeff"][lo:hi])
    frame_mod.check_coeff_range(qvals)
    with metrics.stage("rice_unpack"):
        evals = bitio.unpack_blocks_flat(
            sf["res_words"][rw[lo] : rw[hi]], _exclusive_cumsum(nwr)[:-1],
            nwr, res_counts, sf["k_res"][lo:hi], sf["k_res4"][lo:hi])
    n_sf = hi - lo
    qrows = np.zeros((n_sf, MAX_ORDER), np.int32)
    qrows[np.arange(MAX_ORDER)[None, :] < order[:, None]] = qvals
    erows = np.zeros((n_sf, FRAME_SIZE), np.int32)
    erows[np.arange(FRAME_SIZE)[None, :] < res_counts[:, None]] = evals
    rows = (np.repeat(np.arange(n_sf // channels, dtype=np.int64), channels)
            * channels + sf["channel"][lo:hi])
    fits16 = evals.size == 0 or (
        evals.min() >= -(1 << 15) and evals.max() < (1 << 15))
    return rows, qrows, erows, bool(fits16)


class _Slot:
    """Host staging buffers of one in-flight chunk, pinned when the device
    is CUDA so that the copies can run asynchronously."""

    def __init__(self, rows: int, out_shape: tuple, out_dtype, cuda: bool):
        self._rows = rows
        self._pin = cuda
        self._res: dict = {}
        self.qcoeffs = torch.empty((rows, MAX_ORDER), dtype=torch.int32,
                                   pin_memory=cuda)
        self.order = torch.empty(rows, dtype=torch.int32, pin_memory=cuda)
        self.sftype = torch.empty(rows, dtype=torch.int32, pin_memory=cuda)
        self.out = (torch.empty(out_shape, dtype=out_dtype, pin_memory=True)
                    if cuda else None)
        self.event = torch.cuda.Event() if cuda else None

    def residues(self, dtype) -> torch.Tensor:
        if dtype not in self._res:
            self._res[dtype] = torch.empty((self._rows, FRAME_SIZE),
                                           dtype=dtype, pin_memory=self._pin)
        return self._res[dtype]


def decode_sela(buf: bytes, chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                device=None, metrics=None) -> WavData:
    """Decode .sela bytes to PCM on `device` (default: the CUDA card).

    device="cpu" runs the plain PyTorch versions of the kernels; with no
    device named and no CUDA available this raises. metrics: optional
    utils.metrics.Metrics sink (stages host_parse, host_unpack nesting
    rice_unpack, device_dispatch, device_fetch, host_assemble; counters
    frames, chunks, int32_wire_chunks, coded_bytes, pcm_bytes;
    utils/metrics.py).
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    m = metrics or NULL_METRICS
    header = container.parse_header(buf)
    C = header.channels
    F = header.num_frames
    S = FRAME_SIZE

    with m.stage("host_parse"):
        sf, end = scan(buf, container.HEADER_SIZE, F, C)
        container.parse_trailer(buf, end)  # metadata passthrough; junk raises
    n_valid = sf["n_samples"]
    # int16 wire format halves the device->host PCM transfer for <=16-bit
    # streams (the host upcasts back to int32)
    out_dtype = torch.int16 if header.bits_per_sample <= 16 else torch.int32
    chunk_frames = min(chunk_frames, max(F, 1))
    slots = [_Slot(chunk_frames * C, (chunk_frames, C, S), out_dtype, cuda)
             for _ in range(min(PIPELINE, -(-F // chunk_frames)))]

    def dispatch(index: int, start: int):
        """Host-unpack one chunk and enqueue its device decode."""
        slot = slots[index % len(slots)]
        stop = min(start + chunk_frames, F)
        fcount = stop - start
        lo, hi = start * C, stop * C
        n_sf = hi - lo
        with m.stage("host_unpack"):
            # dense padded rows in file order, permuted to (frame, channel)
            # order via the channel bytes
            rows, qrows, erows, fits16 = unpack(sf, lo, hi, C, m)
            # int16 wire format for the host->device residue copy when every
            # value fits (decode_step upcasts on the device)
            res_t = slot.residues(torch.int16 if fits16 else torch.int32)[:n_sf]
            res_t.numpy()[rows] = erows
            slot.qcoeffs.numpy()[rows] = qrows
            slot.order.numpy()[rows] = sf["order"][lo:hi]
            slot.sftype.numpy()[rows] = sf["sftype"][lo:hi]
        m.count("chunks")
        m.count("int32_wire_chunks", int(not fits16))
        with m.stage("device_dispatch"):
            def put(t: torch.Tensor, *shape):
                return t[:n_sf].view(*shape).to(dev, non_blocking=True)

            x = decode_step(
                put(res_t, fcount, C, S), put(slot.qcoeffs, fcount, C, MAX_ORDER),
                put(slot.order, fcount, C), put(slot.sftype, fcount, C),
                out_dtype=out_dtype,
            )
            if cuda:
                slot.out[:fcount].copy_(x, non_blocking=True)
                slot.event.record(torch.cuda.current_stream(dev))
                x = None
        return slot, x, start, fcount

    chans_out: list[list[np.ndarray]] = [[] for _ in range(C)]

    def collect(item):
        slot, x, start, fcount = item
        with m.stage("device_fetch"):
            if cuda:
                slot.event.synchronize()
                x = slot.out[:fcount]
            # copy out of the staging buffer before its slot is reused
            pcm = x.numpy().astype(np.int32)
        m.count("frames", fcount)
        with m.stage("host_assemble"):
            valid = (np.arange(S)[None, :]
                     < n_valid[start : start + fcount, None])
            for c in range(C):
                chans_out[c].append(pcm[:, c, :][valid])

    inflight = []
    for index, start in enumerate(range(0, F, chunk_frames)):
        inflight.append(dispatch(index, start))
        if len(inflight) >= len(slots):
            collect(inflight.pop(0))
    for item in inflight:
        collect(item)

    with m.stage("host_assemble"):
        channels = [
            np.concatenate(parts) if parts else np.zeros(0, np.int32)
            for parts in chans_out
        ]
    w = WavData(header.sample_rate, header.bits_per_sample, channels)
    m.count("coded_bytes", len(buf))
    m.count("pcm_bytes", w.n_samples * w.n_channels * w.bits_per_sample // 8)
    return w
