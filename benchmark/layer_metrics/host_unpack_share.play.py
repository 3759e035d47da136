"""host_unpack_share.play: % of the traced window in decode_stream's
`host_unpack` stage, which a StreamingPlayer's producer thread records
(codec/decoder.py::unpack of a chunk, bitio's two unpacks nested as
rice_unpack, and the dense rows' fill). Bears on first audio and the play
rate, per layer as play_MBps.traced; names `ratio` as what it moves,
nominally: the cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "play", "host_unpack")
