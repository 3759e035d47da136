"""rice_count_share.encode: % of the traced window in the `rice_count`
stage (native/bitio.py::pack_blocks_flat: bitio's word-count pass,
`rice_block_words`, over both block kinds), inside `host_pack`. Moves
encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "rice_count")
