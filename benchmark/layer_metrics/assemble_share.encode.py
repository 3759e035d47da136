"""assemble_share.encode: % of the traced window in the encoder's
`host_assemble` stage (codec/encoder.py::encode_wav: the tags trailer
written and the stream copied out of the thread's stream buffer as bytes,
once a stream). Moves encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "host_assemble")
