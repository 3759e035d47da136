"""device_idle_share.decode: % of the profiled stretch of decode_sela
requests in which the card ran no kernel and no copy. Bears on the decode
rate, per layer as decode_MBps.traced; names `ratio` as what it moves,
nominally: the cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import idle_share


def read(ctx):
    return idle_share(ctx, "decode")
