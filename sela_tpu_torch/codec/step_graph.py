"""encode_wav's device step as a CUDA graph: one launch a full chunk.

On the card a chunk's device work (codec/encoder.py::device_chunk:
encode_step, the plan, and on the v1 path device_pack) is about a hundred
host calls, PyTorch operations and ctypes launches of the hand-written
kernels, for well under a millisecond of device work. A CUDA graph holds
that chain as it was captured once, kernel for kernel, and replays it with
one launch.

A StepGraph owns static device inputs (x [F, C, S] in the wire dtype,
n_valid [F] int32), the graph captured from them into a private memory
pool, and its static outputs. StepGraphs maps a key (the device, the
chunk's shape and wire dtype, the profile's knobs; whatever changes the
captured chain) to one graph, least recently used first out, and frees a
graph's pool when it drops it. GRAPHS is the process's map; encode_wav
reads it and nothing else keeps graphs.

The launch counters of kernels/coeffs.py, kernels/encode.py and
kernels/pack.py stay per launch run: a capture runs nothing, so it takes
back what its launchers counted, and each replay adds them again. Counted
by difference, so a capture assumes no other thread launches meanwhile.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager

import torch

from ..kernels import coeffs as k_lpc
from ..kernels import encode as k_enc
from ..kernels import pack as k_pack

MAX_GRAPHS = 4   # keys kept: a process encodes few shapes and profiles


def _launch_counts() -> dict:
    return {"lpc": k_lpc.launches, "pack": k_pack.launches, **k_enc.launches}


def _add_launches(delta: dict, sign: int = 1) -> None:
    k_lpc.launches += sign * delta["lpc"]
    k_pack.launches += sign * delta["pack"]
    for name in k_enc.launches:
        k_enc.launches[name] += sign * delta[name]


class StepGraph:
    """One chunk step captured: fn(x, n_valid) -> dict of device tensors,
    for x of `shape` and `dtype` on `device`. fn must enqueue device work
    only (no host read of a device value, no host-to-device copy).

    replay() copies a chunk in, replays and yields the static outputs,
    under the graph's lock; the caller enqueues its copies out inside.
    Every replay's stream first waits for the previous replay's copies out,
    so two threads may share a graph on any streams."""

    def __init__(self, fn, shape, dtype, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.free = torch.cuda.Event()   # after the last replay's copies out
        self.x = torch.zeros(shape, dtype=dtype, device=device)
        self.n_valid = torch.zeros(shape[0], dtype=torch.int32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        before = _launch_counts()
        with torch.cuda.device(device), torch.cuda.graph(
                self.graph, capture_error_mode="thread_local"):
            self.out = fn(self.x, self.n_valid)
        after = _launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        _add_launches(self.launches, -1)

    @contextmanager
    def replay(self, x: torch.Tensor, n_valid: torch.Tensor):
        """x, n_valid: host (pinned, for an asynchronous copy) or device
        tensors of the static inputs' shapes. Yields the static outputs,
        valid on the current stream until the context exits, or None if
        the graph was closed meanwhile (the caller runs the step eagerly)."""
        with self.lock, torch.cuda.device(self.device):
            if self.out is None:
                yield None
                return
            stream = torch.cuda.current_stream()
            stream.wait_event(self.free)
            self.x.copy_(x, non_blocking=True)
            self.n_valid.copy_(n_valid, non_blocking=True)
            self.graph.replay()
            _add_launches(self.launches)
            yield self.out
            self.free.record(stream)

    def close(self) -> None:
        """Wait for the last replay's copies, then free the graph and its
        pool."""
        with self.lock:
            self.free.synchronize()
            self.graph.reset()
            self.out = self.x = self.n_valid = None


class StepGraphs:
    """key -> StepGraph, at most `size` of them (least recently used out)."""

    def __init__(self, size: int = MAX_GRAPHS):
        self.size = size
        self._graphs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key) -> StepGraph | None:
        with self._lock:
            graph = self._graphs.get(key)
            if graph is not None:
                self._graphs.move_to_end(key)
            return graph

    def capture(self, key, fn, shape, dtype, device: torch.device) -> bool:
        """Capture fn for `key` unless a graph is there; True if this call
        captured. Call it after fn has run once eagerly on the device, so
        that every kernel's module is loaded before the capture."""
        with self._lock:
            if key in self._graphs:
                return False
            self._graphs[key] = StepGraph(fn, shape, dtype, device)
            while len(self._graphs) > self.size:
                self._graphs.popitem(last=False)[1].close()
            return True


GRAPHS = StepGraphs()
