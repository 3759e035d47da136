"""fetch_share.decode: % of the traced window in decode_sela's
`device_fetch` stage (the wait on a chunk's CUDA event, the device time not
hidden behind later chunks' host work, and the int32 upcast). Bears on the
decode rate, per layer as decode_MBps.traced; names `ratio` as what it
moves, nominally: the cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "device_fetch")
