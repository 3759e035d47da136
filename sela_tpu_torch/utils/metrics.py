"""Structured metrics/observability — copy of the JAX package's stage timer.

Every codec entry point can be handed a Metrics sink that accumulates
counters (frames, bytes in/out) and per-stage wall times, and can emit one
JSON-lines record per operation. A few dict updates per device chunk; the
device path is untouched.

Stage-name semantics (CUDA work is asynchronous, so host wall-time buckets
do NOT equal device busy-time):
  decode: "host_parse" — container scan; "host_unpack" — Rice unpack +
          scatter into pinned buffers + async H2D and kernel launches;
          "device_fetch" — wait on the chunk's CUDA event (device compute
          not hidden behind later host work + D2H PCM) and the host copy.
For device busy-time use torch.profiler (`profiler_trace`) or CUDA
events, not these.
"""
from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager


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
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stage_s[name] = self.stage_s.get(name, 0.0) + dt
            self.stage_n[name] = self.stage_n.get(name, 0) + 1

    def snapshot(self, op: str) -> dict:
        rec: dict = {"op": op, "ts": time.time()}
        rec.update(self.counters)
        pcm = self.counters.get("pcm_bytes")
        coded = self.counters.get("coded_bytes")
        if pcm and coded:
            rec["ratio"] = round(coded / pcm, 6)
        total_s = sum(self.stage_s.values())
        if pcm and total_s > 0:
            rec["mb_per_s"] = round(pcm / total_s / 1e6, 3)
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
