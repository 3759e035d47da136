"""fetch_share.play: % of the traced window in decode_stream's
`device_fetch` stage, which a StreamingPlayer's producer thread records (the
synchronous copy of the chunk's PCM back, which waits for the card). Bears
on first audio and the play rate, per layer as play_MBps.traced; names
`ratio` as what it moves, nominally: the cell's one other end-to-end metric
(PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "play", "device_fetch")
