"""encode_files_kernels_roofline: the batch's bytes bound (bounds.py: PCM +
coded bytes of the stretch's requests at the card's memory bandwidth) over
the device time of every kernel in the profiled stretch of encode_files
requests, PyTorch's glue kernels included, copies and fills left out; in %.
Bears on the cell's rate, per layer as encode_MBps.files_traced; names
`ratio` as what it moves, the cell's one other end-to-end metric (PERF.md
§2)."""
from benchmark.layer_metrics.common import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx, "encode_files")
