"""Structured metrics/observability — copy of the JAX package's stage timer.

Every codec entry point can be handed a Metrics sink that accumulates
counters (frames, bytes in/out) and per-stage wall times, and can emit one
JSON-lines record per operation. A few dict updates per device chunk; the
device path is untouched. NULL_METRICS, the default, records nothing.

Stage-name semantics (CUDA work is asynchronous, so host wall-time buckets
do NOT equal device busy-time):
  encode: encode_wav, and encode_files, whose groups of files run the same
          chunk engine (codec/encoder.py::encode_chunks).
          "host_frame" — each chunk framed from the files' channels
          straight into its pinned slot (encoder.frame_chunk: one copy a
          file and channel, cast to the wire dtype) with its n_valid;
          "device_dispatch" — encode_step's launches (or a
          replay of its CUDA graph) and the async copies back;
          "device_fetch" — wait on the chunk's CUDA event and the int32
          fallback fetch; "host_pack" — the chunk's Rice pack
          (pack_frames; on the v1 path on the card: the blocks the card
          left, and the splice) and frame emit, which nests:
            "pack_gather" — the PLAN columns, and the numpy before each
                            block kind's native call (two spans a chunk);
            "rice_count"  — bitio's word-count pass (rice_block_words);
            "rice_pack"   — bitio's pack pass (rice_pack_blocks);
            "emit"        — serialize_frames (word slicing, emit_frames
                            into the thread's stream buffer,
                            encoder.StreamBuffer): once a chunk, or once
                            for each file's frames in a chunk;
          host_pack less those four is its self time. bitio's two passes
          run only where the host packs: v2, the CPU, and the escape
          blocks (k = 31) of the v1 path on the card. "host_assemble" —
          after the last chunk, the tags trailer written and the stream
          copied out of the buffer as bytes: once a stream (encode_files:
          once a file).
          Counters: "frames", "chunks"; "framed_bytes" — bytes
          host_frame writes into slots, F C S times the wire dtype's size
          when each sample and pad is written once; "pack_blocks_device" /
          "pack_blocks_host" — Rice blocks (residue and coefficient
          blocks together) packed on the card / by bitio; "int32_fetch" —
          chunks whose int32 residues were fetched after their event;
          "step_graph_replays" — chunks whose device step replayed a CUDA
          graph (codec/step_graph.py), "step_graph_captures" — graphs
          captured, "step_eager" — chunks whose device step ran eagerly
          (every chunk on the CPU; on the card a tail chunk and a shape's
          first full chunk); "emit_buffer_allocs" — allocations and
          growths of the thread's stream buffer: 1 on a thread's first
          run or on one that needs more room than any before, else 0;
          "pcm_bytes" and "coded_bytes"; encode_files also "files" and
          "groups".
          Timed inside the native library, outside Python (add_span):
          "bitio_workers" — the count and pack passes' worker threads,
          wall seconds summed over workers (n: workers run);
          "bitio_workers_on_cpu" — the same workers' on-CPU seconds
          (CLOCK_THREAD_CPUTIME_ID, which some kernels advance only
          in 10 ms ticks: a sum over many workers, not one call's).
  decode: decode_sela (codec/decoder.py).
          "host_parse" — container scan and trailer; "host_unpack" —
          a chunk's unpack (decoder.unpack: bitio's two unpacks, the
          coefficient range check, the scatter into dense rows) and the
          rows' writes into its pinned slot, which nests:
            "rice_unpack" — bitio's unpack_blocks_flat, one span for the
                            coefficients and one for the residues;
          "device_dispatch" — the chunk's async H2D copies, decode_step's
          launches and PyTorch glue, the async D2H copy into the slot and
          its CUDA event (on the CPU: the whole decode_step);
          "device_fetch" — wait on the chunk's CUDA event (device compute
          not hidden behind later host work + D2H PCM) and the int32
          upcast; "host_assemble" — each chunk's valid samples gathered
          per channel, and the channels' final concatenation.
          Counters: "frames", "chunks"; "int32_wire_chunks" — chunks
          whose residues crossed on the int32 wire, not all fitting
          int16 (0 where none did); "coded_bytes" and "pcm_bytes".
  play:   decode_stream, and StreamingPlayer, whose producer thread runs
          it and records its stages (codec/stream.py). One chunk at a
          time, nothing in flight: "host_parse" — the chunk's scan
          (decoder.scan), and the trailer after the last frame;
          "host_unpack" — the chunk's unpack (decoder.unpack) and the
          dense rows' fill, which nests "rice_unpack" as in decode;
          "device_dispatch" — the four host-to-device copies and
          decode_step's launches (on the CPU: the whole decode_step);
          "device_fetch" — the synchronous copy of the chunk's PCM back;
          "host_assemble" — the chunk's blocks sliced, one a frame (views
          of the fetched PCM), before the first is yielded (no stage is
          open while a block is yielded);
          "queue_wait" (StreamingPlayer) — each PacketQueue.put that finds
          the queue full: the producer waiting for the consumer (a put
          with room takes no span).
          Counters: "frames" (decoded), "chunks", "blocks" (yielded),
          "int32_wire_chunks", "coded_bytes" (the header, then each
          chunk's bytes, then the trailer: the whole stream once it has
          run to its end) and "pcm_bytes" (each chunk's samples at the
          stream's depth), as in decode; a player stopped early counts
          what its producer reached.
A nested stage's seconds are also counted in its parent's, so stage
seconds do not add up to the operation's wall time.

While a torch.profiler is recording, each stage is also a profiler range
named "stage:<name>", so a trace shows the stages, with their start, end
and nesting, on the clock of the device's kernels and copies. For device
busy-time use torch.profiler (`profiler_trace`) or CUDA events, not the
stage seconds.
"""
from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager, nullcontext

STAGE = "stage:"   # the prefix of a stage's profiler range


def _profiler_range(name: str):
    """A profiler range for stage `name` while a profiler records, else a
    no-op (one C call where torch is loaded)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return nullcontext()
    return torch.autograd.profiler.record_function(STAGE + name)


class Metrics:
    """Counter + stage-timer accumulator with JSON-lines emission."""

    def __init__(self, sink=None):
        self.counters: dict[str, float] = {}
        self.stage_s: dict[str, float] = {}
        self.stage_n: dict[str, int] = {}
        self._sink = sink  # file-like; defaults to stderr at emit time

    def count(self, name: str, delta: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with _profiler_range(name):
                yield
        finally:
            self.add_span(name, time.perf_counter() - t0)

    def add_span(self, name: str, seconds: float, n: int = 1) -> None:
        """Add `n` spans of `seconds` in all, timed outside Python (the
        native library's worker threads), to stage `name`."""
        self.stage_s[name] = self.stage_s.get(name, 0.0) + seconds
        self.stage_n[name] = self.stage_n.get(name, 0) + n

    def snapshot(self, op: str) -> dict:
        rec: dict = {"op": op, "ts": time.time()}
        rec.update(self.counters)
        pcm = self.counters.get("pcm_bytes")
        coded = self.counters.get("coded_bytes")
        if pcm and coded:
            rec["ratio"] = round(coded / pcm, 6)
        frames = self.counters.get("frames")
        for name, s in self.stage_s.items():
            rec[f"{name}_s"] = round(s, 6)
            if frames:
                rec[f"{name}_us_per_frame"] = round(s / frames * 1e6, 3)
        return rec

    def emit(self, op: str) -> dict:
        """Write one JSON line describing this operation; returns the record."""
        rec = self.snapshot(op)
        print(json.dumps(rec), file=self._sink or sys.stderr, flush=True)
        return rec


class _NullMetrics(Metrics):
    """No-op sink — zero overhead beyond a context-manager enter/exit."""

    def count(self, name, delta=1):
        pass

    @contextmanager
    def stage(self, name):
        yield

    def add_span(self, name, seconds, n=1):
        pass

    def emit(self, op):
        return {}


NULL_METRICS = _NullMetrics()



@contextmanager
def profiler_trace(log_dir: str | None):
    """torch.profiler scope when log_dir is set: CPU activity, and CUDA
    activity where a card is present, written on exit into log_dir as a
    Chrome/Perfetto trace (`trace_<pid>_<time>.json`; open it in
    ui.perfetto.dev or chrome://tracing). Counterpart of the JAX package's
    jax.profiler scope."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}.json"))
