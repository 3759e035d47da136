"""dispatch_share.encode: % of the traced window in the encoder's
`device_dispatch` stage (codec/pipeline.py::encode_step seen from the host:
enqueueing its kernels and PyTorch's glue, and the copies back). Moves
encode_MBps."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode", "device_dispatch")
