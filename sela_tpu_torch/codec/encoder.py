"""Host-side encode orchestration: PCM -> device chunks -> .sela bytes.

Counterpart of sela_tpu/codec/encoder.py. The PCM is framed into [F, C, S]
chunks, each chunk is staged in pinned host buffers and copied to the
device without blocking, codec/pipeline.py::encode_step analyzes and
renders it there (K3, K4, K1, K5, K6, and K8 under partitioned
residues), and what the host needs comes back without blocking into
pinned buffers, behind one CUDA event a chunk, while the card encodes
chunks i+1..i+3 (a PIPELINE-deep software pipeline). The frames are
serialized in order. ≤16-bit PCM crosses to the device as int16.

Two ways to the Rice words, chosen by the profile and the device:

- v1 (residue_partition 1) on the card: the card packs every plain block
  (device_pack: csrc/pack.cu at the plan's word offsets), and the plan,
  the word counts and the flat word buffers come back. The host packs only
  the escape blocks (k = 31), from int32 residues it fetches after the
  event for such a chunk, splices them into their gaps and checks every
  block's count against the plan (splice_frames).
- v2 (partitioned residues), and any encode on the CPU: the residues come
  back (as int16 with per-frame fits16 flags where the PCM is ≤16-bit; a
  chunk whose residues do not all fit fetches its int32 residues after its
  event) and the host packs every block with the native library
  (pack_frames; native/bitio.cpp, built at first use; there is no numpy
  packer).

Either way the steady state never waits on the device mid-chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import BitstreamProfile
from ..format import FRAME_SIZE, MAX_ORDER, SYNC
from ..native import bitio
from ..ops.pack import pack_blocks_at
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


def check_frame_size(frame_size) -> None:
    """Refuse a frame size the container cannot carry: a non-integer
    (TypeError) or one outside [32, FRAME_SIZE] (ValueError, the profile's
    message). sela_tpu refuses 0, negative and < 32 sizes by accident of its
    arithmetic and writes frames over FRAME_SIZE samples that every decoder
    refuses."""
    if not isinstance(frame_size, (int, np.integer)):
        raise TypeError(f"frame_size must be an integer, got {frame_size!r}")
    BitstreamProfile(frame_size=int(frame_size)).validate()


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(len(a), np.int64)
    np.cumsum(a[:-1].astype(np.int64), out=out[1:])
    return out


def pack_frames(plan: np.ndarray, res: np.ndarray, nv: np.ndarray,
                metrics=None):
    """Rice-pack every block of a run of frames, in one native call for the
    residue blocks and one for the coefficient blocks.

    plan: [F, C, len(PLAN) + 32] int32 (PLAN columns, then qcoeffs);
    res: [F, C, S] residues; nv: [F] valid samples a frame. Returns (cols,
    coeff, resid) for serialize_frames: the PLAN columns as [F C] arrays, and
    each block kind's (concatenated words, word count a block). metrics:
    optional Metrics sink (stages pack_gather, then bitio's)."""
    m = metrics or NULL_METRICS
    F, C, S = res.shape
    with m.stage("pack_gather"):
        cols = {k: np.ascontiguousarray(plan[:, :, i].reshape(-1))
                for i, k in enumerate(PLAN)}
        order = cols["order"]
        res_counts = np.repeat(nv, C)
        valid = np.arange(S)[None, :] < res_counts[:, None]
        evals = res.reshape(F * C, S)[valid]
        res_offs = _exclusive_cumsum(res_counts)
    resid = bitio.pack_blocks_flat(evals, res_offs, res_counts, cols["k_res"],
                                   cols["k_res4"], metrics=m)
    with m.stage("pack_gather"):
        qrows = plan[:, :, len(PLAN):].reshape(F * C, MAX_ORDER)
        qvals = qrows[np.arange(MAX_ORDER)[None, :] < order[:, None]]
        q_offs = _exclusive_cumsum(order)
    coeff = bitio.pack_blocks_flat(qvals, q_offs, order, cols["k_coeff"],
                                   metrics=m)
    # the device planned every block's words from its bit counts (K5, K8,
    # K6); the packer counts them again from the values: they must agree
    _check_plan(resid[1], cols["nw_res"], coeff[1], cols["nw_coeff"])
    m.count("pack_blocks_host", 2 * F * C)
    return cols, coeff, resid


def _check_plan(res_counts, res_planned, coeff_counts, coeff_planned):
    if not (np.array_equal(res_counts, res_planned)
            and np.array_equal(coeff_counts, coeff_planned)):
        raise RuntimeError("device Rice plan and host packer disagree on "
                           "block sizes")


def device_pack(out: dict, n_valid: torch.Tensor) -> tuple:
    """Rice-pack a v1 chunk's plain blocks where encode_step left its
    outputs: the card (csrc/pack.cu), or the plain version on the CPU.

    out: encode_step's dict for [F, C, S] frames; n_valid: [F] int32 on the
    same device. Each block kind (residues, then coefficients) is packed in
    one launch at the plan's word offsets (exclusive cumsums of nw_res and
    nw_coeff, each block capped at its planned count), into a flat buffer of
    F C S (F C 32) words: the most a plan can need, as a plain block at its
    optimal k never takes more words than values (a costlier one escapes).
    Returns (res_words, res_nwords, coeff_words, coeff_nwords): int32 word
    buffers in emit order and [F C] int64 word counts, -1 for a block left
    to the host (k = 31, the escape). Reads no device value."""
    F, C, S = out["residues"].shape
    B = F * C

    def kind(values, ks, counts, planned, width):
        caps = planned.reshape(B).contiguous()
        offs = torch.cumsum(caps, 0, dtype=torch.int64) - caps
        return pack_blocks_at(values.reshape(B, width).contiguous(),
                              ks.reshape(B).contiguous(), counts, offs, caps,
                              B * width)

    res = kind(out["residues"], out["k_res"], n_valid.repeat_interleave(C),
               out["nw_res"], S)
    coeff = kind(out["qcoeffs"], out["k_coeff"],
                 out["order"].reshape(B).contiguous(), out["nw_coeff"],
                 MAX_ORDER)
    return res + coeff


def splice_frames(plan: np.ndarray, res, nv: np.ndarray, resid: tuple,
                  coeff: tuple, metrics=None):
    """pack_frames' result for a run of frames whose plain blocks the card
    packed (device_pack).

    plan: [F, C, len(PLAN) + 32] int32; resid and coeff: each block kind's
    (word buffer, word counts) as device_pack made them, on the host: int32
    words, at least the planned total, each block at its planned offset, and
    [F C] counts, -1 for a block left to the host. Those blocks are packed
    here with bitio, from res ([F, C, S] residues; needed only where a
    residue block was left) or the plan's coefficients, and written into
    their gaps. Every block's count, the card's or bitio's, must be the
    plan's, or this raises RuntimeError as pack_frames does. metrics:
    optional Metrics sink (stages pack_gather, bitio's where it packs;
    counters pack_blocks_device and pack_blocks_host)."""
    m = metrics or NULL_METRICS
    F, C = plan.shape[:2]
    with m.stage("pack_gather"):
        cols = {k: np.ascontiguousarray(plan[:, :, i].reshape(-1))
                for i, k in enumerate(PLAN)}

    def host_rows(rows, values, counts, ks):
        """bitio's words and counts of the blocks `rows` of values(), [F C,
        W]."""
        with m.stage("pack_gather"):
            vals = values()[rows]
            vals = vals[np.arange(vals.shape[1])[None, :] < counts[:, None]]
        return bitio.pack_blocks_flat(vals, _exclusive_cumsum(counts), counts,
                                      ks, metrics=m)

    kinds = []
    for (buf, nwords), planned, ks, values, counts in (
            (resid, cols["nw_res"], cols["k_res"],
             lambda: res.reshape(F * C, -1), np.repeat(nv, C)),
            (coeff, cols["nw_coeff"], cols["k_coeff"],
             lambda: plan[:, :, len(PLAN):].reshape(F * C, MAX_ORDER),
             cols["order"])):
        nwords = np.array(nwords, np.int64)
        rows = np.flatnonzero(nwords < 0)
        host = None
        if len(rows):
            host = host_rows(rows, values, counts[rows], ks[rows])
            nwords[rows] = host[1]
        kinds.append((buf, nwords, planned, rows, host))
    _check_plan(kinds[0][1], kinds[0][2], kinds[1][1], kinds[1][2])
    packed = []
    for buf, nwords, planned, rows, host in kinds:
        offs = _exclusive_cumsum(planned)
        words = buf[: int(planned.sum(dtype=np.int64))].view(np.uint32)
        if host is not None:   # each left block into its planned gap
            w, wc = host
            starts = offs[rows] - _exclusive_cumsum(wc)
            words[np.repeat(starts, wc) + np.arange(len(w))] = w
        m.count("pack_blocks_device", len(nwords) - len(rows))
        m.count("pack_blocks_host", len(rows))
        packed.append((words, planned))
    return cols, packed[1], packed[0]


def serialize_frames(packed, nv: np.ndarray, lo: int, hi: int,
                     metrics=None) -> bytes:
    """Serialize frames [lo, hi) of a pack_frames result (native library);
    nv: [F] valid samples a frame of the whole run. metrics: optional
    Metrics sink (stage emit)."""
    cols, coeff, resid = packed
    C = len(cols["order"]) // len(nv)
    s = slice(lo * C, hi * C)

    def words(kind):   # the words and word counts of subframes [lo C, hi C)
        w, wc = kind
        offs = np.concatenate([[0], np.cumsum(wc)])
        return w[offs[s.start] : offs[s.stop]], wc[s]

    with (metrics or NULL_METRICS).stage("emit"):
        (cw, cwc), (rw, rwc) = words(coeff), words(resid)
        return bitio.emit_frames(
            hi - lo, C, SYNC, nv[lo:hi],
            np.tile(np.arange(C, dtype=np.int32), hi - lo),
            cols["sftype"][s], cols["order"][s], cols["k_coeff"][s], cwc,
            cols["k_res"][s], rwc, cw, rw, sf_kr4=cols["k_res4"][s])


class _Slot:
    """Host staging buffers of one in-flight chunk, pinned when the device
    is CUDA so that the copies run asynchronously: the residues (and fits16
    flags) it packs on the host, or the word buffers and counts of the
    blocks the card packed (device_pack)."""

    def __init__(self, frames: int, C: int, S: int, wire, cuda: bool,
                 on_card: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        self.x = buf((frames, C, S), wire)
        self.nv = buf((frames,), torch.int32)
        self.plan = buf((frames, C, len(PLAN) + MAX_ORDER), torch.int32)
        if on_card:
            self.res_words = buf((frames * C * S,), torch.int32)
            self.coeff_words = buf((frames * C * MAX_ORDER,), torch.int32)
            self.nwords = buf((2 * frames * C,), torch.int64)
        else:
            self.fits16 = buf((frames,), torch.int32)
            self.res = buf((frames, C, S), wire)
        self.event = torch.cuda.Event() if cuda else None


def encode_wav(w: WavData, frame_size: int = FRAME_SIZE,
               chunk_frames: int = DEFAULT_CHUNK_FRAMES, profile=None,
               metrics=None, tags: dict | None = None, device=None) -> bytes:
    """Encode WavData to .sela bytes on `device` (default: the CUDA card).

    profile: optional config.BitstreamProfile (defaults = FORMAT.md v1;
    residue_partition=4 is the v2 profile, partitioned residues where they
    are smaller). device="cpu" runs the plain PyTorch versions of the kernels;
    with no device named and no CUDA available this raises. metrics:
    optional utils.metrics.Metrics sink (stages host_frame /
    device_dispatch / device_fetch / host_pack, and inside host_pack
    pack_gather / rice_count / rice_pack / emit; counters frames,
    int32_fetch, pack_blocks_device, pack_blocks_host, pcm_bytes,
    coded_bytes; utils/metrics.py). v1 encodes on the card pack their plain
    blocks there (device_pack), the rest on the host (pack_frames). tags:
    optional metadata appended as a tags trailer (FORMAT.md §Tags).
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
    check_frame_size(frame_size)
    allow_ms = allow_ms and w.bits_per_sample <= 24   # FORMAT.md: 32-bit is LR
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    m = metrics or NULL_METRICS
    wire16 = w.bits_per_sample <= 16
    wire = torch.int16 if wire16 else torch.int32
    # v2's partitioned blocks need their residues on the host; on the CPU
    # the host is the packer
    on_card = cuda and partition == 1

    with m.stage("host_frame"):
        x, n_valid = frame_batches(w.channels, frame_size,
                                   np.int16 if wire16 else np.int32)
    F, C, S = x.shape
    chunk_frames = min(chunk_frames, F)
    slots = [_Slot(chunk_frames, C, S, wire, cuda, on_card)
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
            nv_dev = slot.nv[:fcount].to(dev, non_blocking=True)
            out = encode_step(
                slot.x[:fcount].to(dev, non_blocking=True), nv_dev,
                allow_ms=allow_ms, max_order=max_order, rice_k_max=rice_k_max,
                partition=partition, ms_mode=ms_mode)
            plan = torch.cat([torch.stack([out[k] for k in PLAN], dim=-1),
                              out["qcoeffs"]], dim=-1)
            slot.plan[:fcount].copy_(plan, non_blocking=cuda)
            if on_card:
                rw, rnw, cw, cnw = device_pack(out, nv_dev)
                # the buffers at their bound: the planned totals are not
                # known on the host before the event
                slot.res_words[:rw.numel()].copy_(rw, non_blocking=True)
                slot.coeff_words[:cw.numel()].copy_(cw, non_blocking=True)
                slot.nwords[:2 * rnw.numel()].copy_(torch.cat([rnw, cnw]),
                                                    non_blocking=True)
            else:
                slot.fits16[:fcount].copy_(out["fits16"], non_blocking=cuda)
                slot.res[:fcount].copy_(
                    out["res16"] if wire16 else out["residues"],
                    non_blocking=cuda)
            if cuda:
                slot.event.record(torch.cuda.current_stream(dev))
        # the int32 residues stay on the device for a chunk that turns out
        # to need them: a block left to the host, or an int16 copy that
        # does not hold them
        keep = on_card or wire16
        return slot, start, fcount, out["residues"] if keep else None

    frames: list[bytes] = []

    def collect(item):
        slot, start, fcount, res32 = item
        with m.stage("device_fetch"):
            if cuda:
                slot.event.synchronize()
            if on_card:
                nwords = slot.nwords[:2 * fcount * C].numpy().reshape(2, -1)
                res = None
                if (nwords[0] < 0).any():   # residue blocks left to the host
                    res = res32.cpu().numpy()
                    m.count("int32_fetch")
            else:
                res = slot.res[:fcount].numpy()
                if wire16 and not slot.fits16[:fcount].numpy().all():
                    res = res32.cpu().numpy()
                    m.count("int32_fetch")
        with m.stage("host_pack"):
            nv = n_valid[start:start + fcount]
            plan = slot.plan[:fcount].numpy()
            if on_card:
                packed = splice_frames(
                    plan, res, nv, (slot.res_words.numpy(), nwords[0]),
                    (slot.coeff_words.numpy(), nwords[1]), m)
            else:
                packed = pack_frames(plan, res, nv, m)
            frames.append(serialize_frames(packed, nv, 0, fcount, m))
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
