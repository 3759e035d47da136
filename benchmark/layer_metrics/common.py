"""What the per-layer readers share: the context they read, and the
reductions of a stage timer and of a profiled stretch to shares.

A reader is `layer_metrics/<metric>.py` with `read(ctx) -> float | None`.
It returns None where its cell gives it nothing to read; the harness then
leaves the metric out of the result line.

ctx fields: `op` (the mix's op), `records` (the traced window's records,
as the end-to-end readers get them), `window_s` (that window's seconds),
`stage_s` (the program's stage timer over that window, seconds by stage),
`trace` (trace.summarize's summary of the profiled stretch, or None),
`stretch_bytes` (bounds.codec_bytes of the stretch's requests) and
`peak_bytes_per_s` (the card's memory bandwidth from peaks.json, or None).
"""
from __future__ import annotations

from . import bounds


def stage_share(ctx, op: str, stage: str) -> float | None:
    """% of the traced window that the program spent in `stage`."""
    if ctx.op != op or stage not in ctx.stage_s or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.stage_s[stage] / ctx.window_s


def idle_share(ctx, op: str) -> float | None:
    """% of the profiled stretch in which no kernel or copy ran on the
    device (1 - the union of their intervals over the stretch)."""
    if ctx.op != op or ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


def kernels_roofline(ctx, op: str) -> float | None:
    """% of the bytes bound (bounds.py) in the device time of every kernel
    of the profiled stretch; copies and fills are left out."""
    if (ctx.op != op or ctx.trace is None or not ctx.peak_bytes_per_s
            or ctx.trace["kernel_s"] <= 0):
        return None
    bound = bounds.bound_seconds(ctx.stretch_bytes, ctx.peak_bytes_per_s)
    return 100.0 * bound / ctx.trace["kernel_s"]
