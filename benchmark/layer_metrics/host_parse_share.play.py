"""host_parse_share.play: % of the traced window in decode_stream's
`host_parse` stage, which a StreamingPlayer's producer thread records
(codec/decoder.py::scan of a chunk's frames, and the trailer after the last
frame). Bears on first audio and the play rate, per layer as
play_MBps.traced; names `ratio` as what it moves, nominally: the cell's one
other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "play", "host_parse")
