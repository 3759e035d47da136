"""pack_gather_share.encode: % of the traced window in the encoder's
`pack_gather` stage (codec/encoder.py::pack_frames: the plan columns, the
residue and coefficient gathers and their offsets, before each block
kind's native calls), inside `host_pack`. Moves encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "pack_gather")
