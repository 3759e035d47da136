"""Streaming decode and a bounded packet queue: the playback data path.

Counterpart of sela_tpu/codec/stream.py. `decode_stream` decodes a `.sela`
buffer a chunk of frames at a time: the native scan and Rice unpack of the
chunk on the host (codec/decoder.py::scan and ::unpack: the same
validation, coefficient range check included, as the whole-file decode),
then decode_step (K1, the IIR) on the device, then one block of PCM a frame.
Host memory stays O(chunk), and the first block is ready after one chunk.
`StreamingPlayer` runs decode_stream on a producer thread that fills a
bounded `PacketQueue`; the caller consumes blocks in order.

Both take an optional utils.metrics.Metrics sink (`metrics`; the default
records nothing): decode_stream's stages host_parse, host_unpack (nesting
rice_unpack), device_dispatch, device_fetch and host_assemble, and the
player's queue_wait, with the counters listed under "play" in
utils/metrics.py. The player's stages are recorded on its producer thread.
No stage is open while a block is yielded, so the consumer's time between
blocks is in none of them.
"""
from __future__ import annotations

import threading
from collections import deque
from contextlib import nullcontext
from typing import Iterator

import numpy as np
import torch

from ..format import FRAME_SIZE, MAX_ORDER
from ..ref import container
from ..utils.device import resolve_device
from ..utils.metrics import NULL_METRICS
from .decoder import scan, unpack
from .pipeline import decode_step

DEFAULT_CHUNK_FRAMES = 128  # latency/throughput tradeoff for playback


def decode_stream(buf: bytes, chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                  device=None, metrics=None) -> Iterator[np.ndarray]:
    """Yield PCM blocks [n, C] int32 in stream order, one a frame, decoding
    `chunk_frames` frames at a time on `device` (default: the CUDA card).

    The blocks, concatenated, are int32 at every bit depth, as sela_tpu's
    decode_stream gives them: the oracle's channels (ref.codec), but where a
    reconstruction leaves int32 (both packages wrap it to 32 bits). They
    equal decode_sela(buf)'s channels wherever the samples fit the declared
    bit depth; decode_sela narrows <=16-bit output to int16 (in both
    packages), so on a stream whose samples leave int16 the two differ.
    A chunk's blocks are views of its fetched PCM, all made before the
    first of them is yielded. Damage raises ContainerError when the chunk
    that holds it is reached: every block yielded before it is valid. The
    trailer is parsed after the last frame. device="cpu" runs the plain
    PyTorch versions of the kernels; with no device named and no CUDA
    available this raises. metrics:
    optional utils.metrics.Metrics sink (stages host_parse, host_unpack
    nesting rice_unpack, device_dispatch, device_fetch, host_assemble;
    counters frames, chunks, blocks, int32_wire_chunks, coded_bytes,
    pcm_bytes; utils/metrics.py).
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    dev = resolve_device(device)
    m = metrics or NULL_METRICS
    header = container.parse_header(buf)
    C, F, S = header.channels, header.num_frames, FRAME_SIZE
    pos = counted = container.HEADER_SIZE
    m.count("coded_bytes", counted)
    for start in range(0, F, chunk_frames):
        n = min(chunk_frames, F - start)
        with m.stage("host_parse"):
            sf, pos = scan(buf, pos, n, C)
        with m.stage("host_unpack"):
            rows, qrows, erows, fits16 = unpack(sf, 0, n * C, C, m)
            res = np.zeros((n * C, S), np.int16 if fits16 else np.int32)
            qcoeffs = np.zeros((n * C, MAX_ORDER), np.int32)
            order = np.zeros(n * C, np.int32)
            sftype = np.zeros(n * C, np.int32)
            res[rows], qcoeffs[rows] = erows, qrows
            order[rows], sftype[rows] = sf["order"], sf["sftype"]
        m.count("chunks")
        m.count("int32_wire_chunks", int(not fits16))
        with m.stage("device_dispatch"):
            def put(a: np.ndarray, *shape):
                return torch.from_numpy(a).view(*shape).to(dev)

            x = decode_step(put(res, n, C, S), put(qcoeffs, n, C, MAX_ORDER),
                            put(order, n, C), put(sftype, n, C))
        with m.stage("device_fetch"):
            x = x.cpu().numpy()
        m.count("frames", n)
        with m.stage("host_assemble"):   # views of decode_step's int32 PCM
            blocks = [x[f, :, :nv].T for f, nv in enumerate(sf["n_samples"])]
        m.count("coded_bytes", pos - counted)
        counted = pos
        m.count("pcm_bytes", int(sf["n_samples"].sum()) * C
                * header.bits_per_sample // 8)
        for block in blocks:
            m.count("blocks")
            yield block
    with m.stage("host_parse"):
        container.parse_trailer(buf, pos)  # metadata passthrough; junk raises
    m.count("coded_bytes", len(buf) - counted)


class PacketQueue:
    """Bounded, ordered, thread-safe PCM block queue.

    put() blocks when full (backpressure on the decode producer), get()
    blocks until a block or end-of-stream arrives. close() signals EOS;
    abort() drains and unblocks everyone (player teardown).
    """

    def __init__(self, max_blocks: int = 32):
        self._q: deque = deque()
        self._max = max_blocks
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._aborted = False

    def put(self, block: np.ndarray) -> bool:
        """Queue a block; False when the queue was aborted."""
        with self._not_full:
            while len(self._q) >= self._max and not self._aborted:
                self._not_full.wait()
            if self._aborted:
                return False
            self._q.append(block)
            self._not_empty.notify()
            return True

    def get(self):
        """Next block, or None at end-of-stream/abort."""
        with self._not_empty:
            while not self._q and not self._closed and not self._aborted:
                self._not_empty.wait()
            if self._q and not self._aborted:
                block = self._q.popleft()
                self._not_full.notify()
                return block
            return None

    def full(self) -> bool:
        """Whether a put() now would wait for the consumer."""
        with self._lock:
            return len(self._q) >= self._max and not self._aborted

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            self._q.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


class StreamingPlayer:
    """Producer thread: decode_stream -> PacketQueue. Consumer: the caller.

    Use: `for block in StreamingPlayer(buf): ...`. The device is resolved
    here, on the caller's thread, and handed to the producer, which runs the
    device work on it whatever that thread's current device is. An error in
    the producer ends the stream and is raised to the consumer after the
    blocks before it. metrics: optional utils.metrics.Metrics sink, handed
    to the producer's decode_stream; the producer also records each put
    that finds the queue full, its wait for the consumer, as `queue_wait`.
    """

    def __init__(self, buf: bytes, chunk_frames: int = DEFAULT_CHUNK_FRAMES,
                 max_blocks: int = 32, device=None, metrics=None):
        self.header = container.parse_header(buf)
        self.queue = PacketQueue(max_blocks)
        self.error: Exception | None = None
        self._thread = threading.Thread(
            target=self._produce,
            args=(buf, chunk_frames, resolve_device(device),
                  metrics or NULL_METRICS), daemon=True)
        self._thread.start()

    def _produce(self, buf: bytes, chunk_frames: int, device, m) -> None:
        try:
            for block in decode_stream(buf, chunk_frames, device=device,
                                       metrics=m):
                # only the producer puts: a queue with room now keeps it
                wait = (m.stage("queue_wait") if self.queue.full()
                        else nullcontext())
                with wait:
                    queued = self.queue.put(block)
                if not queued:
                    return  # aborted
        except Exception as e:  # surfaced to the consumer loop
            self.error = e
        finally:
            self.queue.close()

    def __iter__(self):
        while True:
            block = self.queue.get()
            if block is None:
                break
            yield block
        self._thread.join()
        if self.error is not None:
            raise self.error

    def stop(self) -> None:
        self.queue.abort()
        self._thread.join()
