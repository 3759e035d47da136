"""encode_kernels_roofline: the encode's bytes bound (bounds.py: PCM + coded
bytes at the card's memory bandwidth) over the device time of every kernel
in the profiled stretch, PyTorch's glue kernels included, copies and fills
left out; in %. Moves encode_MBps."""
from benchmark.layer_metrics.common import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx, "encode")
