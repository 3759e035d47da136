"""emit_share.encode: % of the traced window in the encoder's `emit` stage
(codec/encoder.py::serialize_frames: the words of each subframe and
bitio's frame emit), inside `host_pack`. Moves encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "emit")
