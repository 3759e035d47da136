"""rice_pack_share.encode: % of the traced window in the `rice_pack` stage
(native/bitio.py::pack_blocks_flat: bitio's pack pass, `rice_pack_blocks`,
over both block kinds), inside `host_pack`. Moves encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "rice_pack")
