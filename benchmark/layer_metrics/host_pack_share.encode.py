"""host_pack_share.encode: % of the traced window in the encoder's
`host_pack` stage (codec/encoder.py: the native Rice pack and frame emit of
a chunk). Moves encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "host_pack")
