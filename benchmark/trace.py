"""The traced run's two sources: the program's stage timer, and one
profiled stretch of requests.

`StageRecorder` is the program's own `utils.metrics.Metrics` with a
`torch.profiler.record_function` range opened under each stage's name: the
trace keeps each stage's start and end, so that an idle gap of the device
can be laid beside what the host was doing. `profile_stretch` runs a few requests
under `torch.profiler` (CUPTI) and reduces the trace to a summary in
memory; nothing of the trace is written to disk.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

STAGE = "stage:"          # the prefix of a stage's profiler range
STRETCH = "bench:stretch"  # the profiled stretch's own range
REQUEST = "bench:request"  # one request of the stretch
COPIES = ("Memcpy", "Memset")


def stage_recorder():
    """A Metrics sink of the program whose stages are profiler ranges."""
    from torch.profiler import record_function

    from sela_tpu_torch.utils.metrics import Metrics

    class StageRecorder(Metrics):
        @contextmanager
        def stage(self, name: str):
            t0 = time.perf_counter()
            try:
                with record_function(STAGE + name):
                    yield
            finally:
                dt = time.perf_counter() - t0
                self.stage_s[name] = self.stage_s.get(name, 0.0) + dt
                self.stage_n[name] = self.stage_n.get(name, 0) + 1

    return StageRecorder()


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def summarize(events: list, top: int = 10) -> dict | None:
    """Reduce profiler events (name, device?, start_us, end_us) to the
    stretch's device busy time, kernel time, top device operations and
    longest idle gaps, each gap labelled with the host range (a program
    stage first, else a benchmark range) that covers most of it. None when
    the trace holds no stretch or no device operation."""
    stretch = [(a, b) for name, dev, a, b in events
               if not dev and name == STRETCH]
    # a range of the host's also shows on the device's timeline as a user
    # annotation: it is no device work
    device = [(name, a, b) for name, dev, a, b in events
              if dev and not name.startswith((STAGE, "bench:"))]
    if not stretch or not device:
        return None
    w0, w1 = stretch[0]
    device = [(n, max(a, w0), min(b, w1)) for n, a, b in device
              if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in device])
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    hosts = [(name, a, b) for name, dev, a, b in events
             if not dev and name != STRETCH and name.startswith(
                 (STAGE, "bench:"))]

    def label(g0, g1):
        """The stage that covers most of the gap, else the innermost of
        the benchmark's ranges, else the request."""
        cover = {}
        for name, a, b in hosts:
            o = _overlap(g0, g1, a, b)
            if o > 0:
                cover[name] = cover.get(name, 0.0) + o
        for tier in (lambda n: n.startswith(STAGE),
                     lambda n: n != REQUEST, lambda n: True):
            pick = {k: v for k, v in cover.items() if tier(k)}
            if pick:
                name = max(pick, key=pick.get)
                return name[len(STAGE):] if name.startswith(STAGE) else name
        return "outside any range"

    by_name = {}
    for n, a, b in device:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=sum(b - a for n, a, b in device
                     if not n.startswith(COPIES)) / 1e6,
        device_ops=[[n, v / 1e6] for n, v in ops],
        idle_gaps=[[label(a, b), (b - a) / 1e6] for a, b in longest],
    )


def profile_stretch(run, device) -> dict | None:
    """Run `run()` under torch.profiler and summarize its trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            run()
            if cuda:
                torch.cuda.synchronize()
    events = [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
               e.time_range.end) for e in prof.events()]
    return summarize(events)
