"""Host-side encode orchestration: PCM -> device chunks -> .sela bytes.

Counterpart of sela_tpu/codec/encoder.py. One chunk engine
(encode_chunks) runs every encode chunk, of encode_wav's track and of
codec/corpus.py::encode_files' groups of files alike. It takes the files'
channels as they are: each chunk is framed straight into a pinned host
buffer (frame_chunk: one numpy copy a file and channel that casts to the
wire dtype, int16 where the PCM is ≤16-bit, and lays the samples out as
[f, C, S]; no framed copy of a whole track or group exists), copied to the
device without blocking, codec/pipeline.py::encode_step analyzes and
renders it there (K3, K4, K1, K5, K6, and K8 under partitioned residues),
and what the host needs comes back without blocking into pinned buffers,
behind one CUDA event a chunk, while the card encodes chunks i+1..i+3 (a
PIPELINE-deep software pipeline). The frames are serialized in order, by
the native emit, straight into the calling thread's stream buffer
(StreamBuffer: reused from run to run, so each coded byte is written once
there and copied once into the bytes returned).

On the card a full chunk (chunk_frames frames) replays a CUDA graph of its
device work (codec/step_graph.py), captured after the first full chunk of
its shape and profile ran eagerly; a tail chunk, and a run shorter than one
chunk, run eagerly. The streams are the same either way.

One host pack (pack_frames) turns a chunk into Rice words, and checks every
block's word count against the device's plan. Where they come from is
chosen by the profile and the device:

- v1 (residue_partition 1) on the card: the card packs every plain block
  (device_pack: csrc/pack.cu at the plan's word offsets), and the plan,
  the word counts and the flat word buffers come back. bitio packs only
  the escape blocks (k = 31), from int32 residues fetched after the event
  for such a chunk, and they are spliced into their gaps.
- v2 (partitioned residues), and any encode on the CPU: the residues come
  back (as int16 with per-frame fits16 flags on the int16 wire; a chunk
  whose residues do not all fit fetches its int32 residues after its
  event) and bitio packs every block (native/bitio.cpp, built at first
  use; there is no numpy packer).

Either way the steady state never waits on the device mid-chunk.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext

import numpy as np
import torch

from ..config import BitstreamProfile
from ..format import FRAME_SIZE, MAX_ORDER, RESIDUE_PARTS, SYNC
from ..native import bitio
from ..ops.pack import pack_blocks_at
from ..ref import container
from ..ref.wav import WavData
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from . import step_graph
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


def frame_counts(lengths, frame_size: int = FRAME_SIZE):
    """Files' sample counts -> (each file's frame count [files] int64,
    n_valid [F] int32 of the files' frames one after another): what
    frame_batches gives each file, from the lengths alone."""
    lengths = np.asarray(lengths, np.int64)
    counts = -(-lengths // frame_size)
    n_valid = np.full(int(counts.sum()), frame_size, np.int32)
    tail = lengths % frame_size
    n_valid[(np.cumsum(counts) - 1)[tail > 0]] = tail[tail > 0]
    return counts, n_valid


def frame_chunk(x: torch.Tensor, files, first: np.ndarray, start: int,
                stop: int) -> int:
    """Frame frames [start, stop) of the files' frames one after another
    into x[:stop - start] ([f, C, S] host tensor in the wire dtype): for
    each file and channel one numpy copy of its full frames, a [k, S] view
    of the channel, cast in the copy (as frame_batches casts), then its
    last partial frame's samples and that frame's padding zeroed. Every
    element of x[:stop - start] is written once and nothing else is, so x
    may hold anything before. files: one list of C channels a file; first:
    [files + 1] the first frame of each file (exclusive cumsum of
    frame_counts' counts). Returns the elements written.

    One thread by design: PyTorch's intra-op pool, woken for each copy,
    framed no faster inside the encode pipeline on an H100 host and far
    slower for many small files (PERF.md §6)."""
    S = x.shape[2]
    out = x.numpy()
    written = 0
    j = int(np.searchsorted(first, start, side="right")) - 1
    while j < len(files) and first[j] < stop:
        f0 = int(first[j])
        lo, hi = max(f0, start), min(int(first[j + 1]), stop)
        rows = out[lo - start:hi - start]
        for c, ch in enumerate(files[j]):
            src = np.asarray(ch)
            a, b = (lo - f0) * S, min((hi - f0) * S, len(src))
            full = (b - a) // S
            np.copyto(rows[:full, c], src[a:a + full * S].reshape(full, S),
                      casting="unsafe")
            written += full * S
            if full < hi - lo:   # the file's last frame, partial
                tail = b - a - full * S
                rows[full, c, :tail] = src[a + full * S:b]
                rows[full, c, tail:] = 0
                written += S
        j += 1
    return written


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


def pack_frames(plan: np.ndarray, res, nv: np.ndarray, metrics=None,
                card=None):
    """Rice-pack a run of frames for serialize_frames, and check every
    block's word count against the device's plan (RuntimeError).

    plan: [F, C, len(PLAN) + 32] int32 (PLAN columns, then qcoeffs); res:
    [F, C, S] residues, read only where bitio packs a residue block; nv:
    [F] valid samples a frame. card: None, and bitio packs every block in
    one native call a block kind; or device_pack's words on the host,
    ((res_words, res_nwords), (coeff_words, coeff_nwords)): int32 buffers,
    each block at its planned word offset, and [F C] word counts, -1 for a
    block left to bitio and written into its gap. Returns (cols, coeff,
    resid): the PLAN columns as [F C] arrays, and each block kind's
    (concatenated words, word count a block). metrics: optional Metrics
    sink (stages pack_gather, twice, and bitio's where it packs; counters
    pack_blocks_host, and pack_blocks_device where the card packed)."""
    m = metrics or NULL_METRICS
    F, C = plan.shape[:2]
    # the blocks bitio packs: every block, or those the card left
    left = ((slice(None),) * 2 if card is None
            else [np.flatnonzero(nw < 0) for _, nw in card])
    kinds = []   # a block kind's rows bitio packs, its words, all counts
    for i, (kind, rows) in enumerate(zip(("res", "coeff"), left)):
        with m.stage("pack_gather"):
            if i == 0:   # the PLAN columns, in the first span
                cols = {k: np.ascontiguousarray(plan[:, :, j].reshape(-1))
                        for j, k in enumerate(PLAN)}
                values, counts = res, np.repeat(nv, C)
            else:
                values, counts = plan[:, :, len(PLAN):], cols["order"]
            counts = counts[rows]
            if len(counts):
                vals = values.reshape(F * C, -1)[rows]
                vals = vals[np.arange(vals.shape[1])[None, :]
                            < counts[:, None]]
                offs = _exclusive_cumsum(counts)
        host = bitio.pack_blocks_flat(
            vals, offs, counts, cols["k_" + kind][rows],
            cols["k_res4"][rows] if i == 0 else None,
            metrics=m) if len(counts) else None
        got = host[1] if card is None else np.array(card[i][1], np.int64)
        if card is not None and host is not None:
            got[rows] = host[1]
        kinds.append((rows, host, got))
    # the device planned every block's words from its bit counts (K5, K8,
    # K6); the card's packer and bitio count them again: they must agree
    if not all(np.array_equal(got, cols[k]) for (_, _, got), k
               in zip(kinds, ("nw_res", "nw_coeff"))):
        raise RuntimeError("device Rice plan and host packer disagree on "
                           "block sizes")
    if card is None:
        m.count("pack_blocks_host", 2 * F * C)
        return cols, kinds[1][1], kinds[0][1]
    packed = []
    for (buf, _), (rows, host, _), planned in zip(
            card, kinds, (cols["nw_res"], cols["nw_coeff"])):
        words = buf[: int(planned.sum(dtype=np.int64))].view(np.uint32)
        if host is not None:   # each left block into its planned gap
            w, wc = host
            starts = _exclusive_cumsum(planned)[rows] - _exclusive_cumsum(wc)
            words[np.repeat(starts, wc) + np.arange(len(w))] = w
        m.count("pack_blocks_device", len(planned) - len(rows))
        m.count("pack_blocks_host", len(rows))
        packed.append((words, planned))
    return cols, packed[1], packed[0]


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


def device_chunk(x: torch.Tensor, n_valid: torch.Tensor, on_card: bool,
                 wire16: bool, **step) -> dict:
    """One chunk's device work, enqueued and never read on the host (what
    step_graph captures): encode_step(x, n_valid, **step) and what the host
    fetches of it. Returns plan ([F, C, len(PLAN) + 32] int32: the PLAN
    columns, then the coefficients), residues (the int32 residues, for a
    chunk that turns out to need them) and, on the card's v1 path
    (on_card), device_pack's res_words and coeff_words and their [2 F C]
    nwords, else res (the residues on the wire: int16 where wire16) and
    fits16."""
    out = encode_step(x, n_valid, **step)
    got = dict(plan=torch.cat([torch.stack([out[k] for k in PLAN], dim=-1),
                               out["qcoeffs"]], dim=-1),
               residues=out["residues"])
    if on_card:
        rw, rnw, cw, cnw = device_pack(out, n_valid)
        got.update(res_words=rw, coeff_words=cw, nwords=torch.cat([rnw, cnw]))
    else:
        got.update(res=out["res16"] if wire16 else out["residues"],
                   fits16=out["fits16"])
    return got


def serialize_frames(packed, nv: np.ndarray, lo: int, hi: int,
                     metrics=None, out: np.ndarray | None = None):
    """Serialize frames [lo, hi) of a pack_frames result (native library);
    nv: [F] valid samples a frame of the whole run. Returns their bytes, or
    with out (a uint8 array, at least frames_bytes long) writes them at its
    start and returns their count. metrics: optional Metrics sink (stage
    emit)."""
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
            cols["k_res"][s], rwc, cw, rw, sf_kr4=cols["k_res4"][s], out=out)


def frames_bytes(packed, nv: np.ndarray, lo: int, hi: int) -> int:
    """The bytes serialize_frames writes for frames [lo, hi), from the
    plan's word counts (which pack_frames checked against the words)."""
    cols = packed[0]
    C = len(cols["order"]) // len(nv)
    s = slice(lo * C, hi * C)
    return bitio.frames_size(hi - lo, cols["k_res"][s], cols["nw_coeff"][s],
                             cols["nw_res"][s])


def stream_bound(counts, C: int, S: int, partitioned: bool) -> int:
    """The most bytes that files of counts[j] frames of C channels and S
    samples a frame can code to, headers included, tags not: a block's
    words never outnumber its values, as a plain block at its chosen k
    never takes more bits than the 32-bit escape (FORMAT.md §Rice coding;
    device_pack's bound), so a subframe holds at most S residue and
    MAX_ORDER coefficient words, after 11 bytes of fields (RESIDUE_PARTS
    more where partitioned)."""
    sub = 11 + (RESIDUE_PARTS if partitioned else 0) + 4 * (S + MAX_ORDER)
    return (len(counts) * container.HEADER_SIZE
            + int(np.sum(counts, dtype=np.int64)) * (6 + C * sub))


_local = threading.local()


class StreamBuffer:
    """The calling thread's stream buffer, into which the frame emit writes
    each coded byte once: a uint8 array kept in a threading.local, so a
    thread's later runs reuse its pages instead of faulting new ones.
    Taken for a run with room for `nbytes` (a new np.empty where the
    thread's is shorter or missing; counter emit_buffer_allocs), written
    from offset 0, and grown, its used prefix copied, if a write ever
    finds too little room. take() copies a slice out as bytes."""

    def __init__(self, nbytes: int, metrics):
        self.m = metrics
        self.pos = 0
        self.buf = getattr(_local, "buf", None)
        grow = self.buf is None or len(self.buf) < nbytes
        if grow:
            self.buf = _local.buf = np.empty(nbytes, np.uint8)
        self.m.count("emit_buffer_allocs", int(grow))

    def reserve(self, n: int) -> np.ndarray:
        """The free bytes, at least n of them."""
        if self.pos + n > len(self.buf):
            grown = np.empty(max(2 * len(self.buf), self.pos + n), np.uint8)
            grown[:self.pos] = self.buf[:self.pos]
            self.buf = _local.buf = grown
            self.m.count("emit_buffer_allocs")
        return self.buf[self.pos:]

    def write(self, data: bytes) -> None:
        self.reserve(len(data))[:len(data)] = np.frombuffer(data, np.uint8)
        self.pos += len(data)

    def frames(self, packed, nv: np.ndarray, lo: int, hi: int) -> None:
        """Emit frames [lo, hi) of a pack_frames result here."""
        free = self.reserve(frames_bytes(packed, nv, lo, hi))
        self.pos += serialize_frames(packed, nv, lo, hi, self.m, out=free)

    def take(self, start: int, stop: int) -> bytes:
        return self.buf[start:stop].tobytes()


class _Slot:
    """Host staging buffers of one in-flight chunk, pinned when the device
    is CUDA so that the copies run asynchronously: the residues (and fits16
    flags) it packs on the host, or the word buffers and counts of the
    blocks the card packed (device_pack)."""

    def __init__(self, frames: int, C: int, S: int, wire, cuda: bool,
                 on_card: bool):
        def buf(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=cuda)

        self.on_card = on_card
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
        self.res32 = None   # the device copy of a replayed chunk's residues

    def copy_back(self, out: dict, fcount: int, keep32: bool, copy32: bool):
        """Enqueue the copies of a chunk's device_chunk outputs into these
        buffers, then the event; returns the int32 residues kept on the
        device where keep32 (a copy of them where copy32, as a graph's
        static outputs are overwritten by the next replay)."""
        cuda = self.event is not None
        self.plan[:fcount].copy_(out["plan"], non_blocking=cuda)
        if self.on_card:
            # the buffers at their bound: the planned totals are not known
            # on the host before the event
            for name in ("res_words", "coeff_words", "nwords"):
                src = out[name]
                getattr(self, name)[:src.numel()].copy_(src, non_blocking=True)
        else:
            self.fits16[:fcount].copy_(out["fits16"], non_blocking=cuda)
            self.res[:fcount].copy_(out["res"], non_blocking=cuda)
        res32 = out["residues"] if keep32 else None
        if res32 is not None and copy32:
            if self.res32 is None:
                self.res32 = torch.empty_like(res32)
            res32 = self.res32.copy_(res32, non_blocking=True)
        if cuda:
            self.event.record(torch.cuda.current_stream(out["plan"].device))
        return res32


def encode_chunks(files: list, wire: torch.dtype, frame_size: int,
                  dev: torch.device, chunk_frames: int, step: dict, metrics,
                  emit) -> None:
    """Encode the files' frames, one file after another, on `dev` chunk by
    chunk, PIPELINE chunks in flight: the engine of encode_wav and
    encode_files.

    files: one list of C channels a file; wire: the dtype the frames cross
    in (int16 only where the PCM is ≤16-bit); frame_size: S; step:
    encode_step's profile knobs. Each chunk is framed straight into its
    pinned slot (frame_chunk). emit(start, fcount, packed, nv) is called
    for each chunk in order, inside its host_pack stage, with pack_frames'
    result for frames [start, start + fcount) and their n_valid. metrics:
    optional Metrics sink."""
    m = metrics or NULL_METRICS
    cuda = dev.type == "cuda"
    if any(len(ch) != len(f[0]) for f in files for ch in f):
        raise ValueError("a file's channels differ in length")
    counts, n_valid = frame_counts([len(f[0]) for f in files], frame_size)
    first = np.concatenate([[0], np.cumsum(counts)])
    F, C, S = len(n_valid), len(files[0]), frame_size
    wire16 = wire == torch.int16
    # v2's partitioned blocks need their residues on the host; on the CPU
    # the host is the packer
    on_card = cuda and step.get("partition", 1) == 1
    full = chunk_frames   # a chunk of this many frames replays a graph
    chunk_frames = min(chunk_frames, F)
    slots = [_Slot(chunk_frames, C, S, wire, cuda, on_card)
             for _ in range(min(PIPELINE, -(-F // chunk_frames)))]

    def run_step(xd, nvd):
        return device_chunk(xd, nvd, on_card, wire16, **step)

    if cuda:
        gdev = torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
        key = (gdev, full, C, S, wire, on_card, *step.items())
    # the int32 residues stay on the device for a chunk that turns out to
    # need them: a block left to the host, or an int16 copy that does not
    # hold them
    keep32 = on_card or wire16

    def dispatch(index: int, start: int):
        """Stage one chunk and enqueue its device encode and copies back:
        a replay of the key's graph for a full chunk on the card, else the
        eager step (a full chunk's first, which then captures the graph)."""
        slot = slots[index % len(slots)]
        stop = min(start + chunk_frames, F)
        fcount = stop - start
        with m.stage("host_frame"):
            written = frame_chunk(slot.x, files, first, start, stop)
            slot.nv.numpy()[:fcount] = n_valid[start:stop]
        m.count("framed_bytes", written * slot.x.element_size())
        with m.stage("device_dispatch"):
            graph = (step_graph.GRAPHS.get(key) if cuda and fcount == full
                     else None)
            replay = graph.replay(slot.x, slot.nv) if graph else nullcontext()
            with replay as out:
                if out is not None:
                    res32 = slot.copy_back(out, fcount, keep32, copy32=True)
                    m.count("step_graph_replays")
            if out is None:
                res32 = slot.copy_back(run_step(
                    slot.x[:fcount].to(dev, non_blocking=True),
                    slot.nv[:fcount].to(dev, non_blocking=True)),
                    fcount, keep32, copy32=False)
                m.count("step_eager")
                if (cuda and fcount == full and step_graph.GRAPHS.capture(
                        key, run_step, slot.x.shape, wire, gdev)):
                    m.count("step_graph_captures")
        return slot, start, fcount, res32

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
            card = (((slot.res_words.numpy(), nwords[0]),
                     (slot.coeff_words.numpy(), nwords[1]))
                    if on_card else None)
            packed = pack_frames(slot.plan[:fcount].numpy(), res, nv, m, card)
            emit(start, fcount, packed, nv)
        m.count("chunks")
        m.count("frames", fcount)

    inflight = []
    for index, start in enumerate(range(0, F, chunk_frames)):
        inflight.append(dispatch(index, start))
        if len(inflight) >= len(slots):
            collect(inflight.pop(0))
    for item in inflight:
        collect(item)


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
    pack_gather / rice_count / rice_pack / emit, then host_assemble;
    counters frames, chunks, framed_bytes, int32_fetch, pack_blocks_device,
    pack_blocks_host, step_graph_replays, step_graph_captures, step_eager,
    emit_buffer_allocs, pcm_bytes, coded_bytes; utils/metrics.py). v1
    encodes on the card pack their plain blocks there (device_pack), the
    rest on the host (pack_frames).
    tags: optional metadata appended as a tags trailer (FORMAT.md §Tags).
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
    m = metrics or NULL_METRICS

    (F,), _ = frame_counts([w.n_samples], frame_size)
    header = container.SelaHeader(w.sample_rate, w.bits_per_sample,
                                  w.n_channels, int(F))
    trailer = container.serialize_tags(tags) if tags else b""
    stream = StreamBuffer(stream_bound([F], w.n_channels, frame_size,
                                       partition != 1) + len(trailer), m)
    stream.write(container.serialize_file(header, []))
    encode_chunks(
        [w.channels], torch.int16 if w.bits_per_sample <= 16 else torch.int32,
        frame_size, dev, chunk_frames,
        dict(allow_ms=allow_ms, max_order=max_order, rice_k_max=rice_k_max,
             partition=partition, ms_mode=ms_mode), m,
        lambda start, fcount, packed, nv: stream.frames(packed, nv, 0,
                                                        fcount))
    with m.stage("host_assemble"):
        stream.write(trailer)
        buf = stream.take(0, stream.pos)
    m.count("pcm_bytes", w.n_samples * w.n_channels * w.bits_per_sample // 8)
    m.count("coded_bytes", len(buf))
    return buf
