"""encode_MBps.files_traced: encode_MBps (e2e_metrics/encode_MBps.py) of
encode_files requests over the traced run's window, where the stage timer
is on. Stands per layer where the rate spreads too widely for a bound
(PERF.md §2); it names `ratio` as what it moves because that is the
cell's one other end-to-end metric."""
import os

from benchmark.traffic import load_named

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read(ctx):
    if ctx.op != "encode_files" or ctx.window_s <= 0:
        return None
    return load_named("e2e_metrics", "encode_MBps", BENCH).read(
        ctx.records, ctx.window_s)
