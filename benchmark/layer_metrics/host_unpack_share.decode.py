"""host_unpack_share.decode: % of the traced window in decode_sela's
`host_unpack` stage (codec/decoder.py::unpack: bitio's two unpacks, the
range check and the scatter into dense rows, then the rows' writes into the
chunk's pinned slot; rice_unpack included). Bears on the decode rate, per
layer as decode_MBps.traced; names `ratio` as what it moves, nominally: the
cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "host_unpack")
