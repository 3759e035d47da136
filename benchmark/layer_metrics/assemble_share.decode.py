"""assemble_share.decode: % of the traced window in decode_sela's
`host_assemble` stage (each chunk's valid samples gathered per channel, and
the channels' final concatenation). Bears on the decode rate, per layer as
decode_MBps.traced; names `ratio` as what it moves, nominally: the cell's
one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "host_assemble")
