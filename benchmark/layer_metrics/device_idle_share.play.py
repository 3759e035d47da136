"""device_idle_share.play: % of the profiled stretch of player requests in
which the card ran no kernel and no copy. Bears on first audio and the
play rate, per layer; names `ratio` as what it moves, nominally: the
cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import idle_share


def read(ctx):
    return idle_share(ctx, "play")
