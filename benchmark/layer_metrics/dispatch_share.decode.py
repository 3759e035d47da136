"""dispatch_share.decode: % of the traced window in decode_sela's
`device_dispatch` stage (codec/pipeline.py::decode_step seen from the host:
the chunk's copies to the card, K1 and K2 and PyTorch's glue enqueued, the
copy back and its event). Bears on the decode rate, per layer as
decode_MBps.traced; names `ratio` as what it moves, nominally: the cell's
one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "device_dispatch")
