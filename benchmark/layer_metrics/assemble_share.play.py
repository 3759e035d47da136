"""assemble_share.play: % of the traced window in decode_stream's
`host_assemble` stage, which a StreamingPlayer's producer thread records
(the chunk's blocks sliced and cast to int32, one a frame, before the first
is yielded). Bears on first audio and the play rate, per layer as
play_MBps.traced; names `ratio` as what it moves, nominally: the cell's one
other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "play", "host_assemble")
