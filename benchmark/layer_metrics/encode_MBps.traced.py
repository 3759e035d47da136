"""encode_MBps.traced: encode_MBps (e2e_metrics/encode_MBps.py) over the
traced run's window, where the stage timer is on. Stands per layer where
the host's speed spreads the rate too widely for a bound (PERF.md §2); it
names `ratio` as what it moves only because that is the cell's one other
end-to-end metric."""
import os

from benchmark.traffic import load_named

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read(ctx):
    if ctx.op != "encode" or ctx.window_s <= 0:
        return None
    return load_named("e2e_metrics", "encode_MBps", BENCH).read(
        ctx.records, ctx.window_s)
