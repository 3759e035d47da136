"""device_idle_share.files: % of the profiled stretch of encode_files requests
in which the card ran no kernel and no copy. Bears on the cell's rate, per
layer as encode_MBps.files_traced; names `ratio` as what it moves, the
cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import idle_share


def read(ctx):
    return idle_share(ctx, "encode_files")
