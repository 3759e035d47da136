"""first_audio_ms_p95.play: the 95th percentile (numpy's linear one), over
the traced window's requests, of the milliseconds from a StreamingPlayer's
construction to its first block (the play op's `first_s`), the stage timer
on. Kept per layer for its spread (PERF.md §2); names `ratio` as what it
moves only because that is the cell's one other end-to-end metric."""
import numpy as np


def read(ctx):
    if ctx.op != "play":
        return None
    ms = [r["first_s"] * 1e3 for r in ctx.records
          if r.get("first_s") is not None]
    return float(np.percentile(ms, 95)) if ms else None
