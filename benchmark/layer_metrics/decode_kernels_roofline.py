"""decode_kernels_roofline: the decode's bytes bound (bounds.py: PCM + coded
bytes of the stretch's requests at the card's memory bandwidth) over the
device time of every kernel in the profiled stretch of decode_sela
requests (K1, K2 and PyTorch's glue kernels), copies and fills left out;
in %. Bears on the decode rate, per layer as decode_MBps.traced; names
`ratio` as what it moves, nominally: the cell's one other end-to-end
metric (PERF.md §2)."""
from benchmark.layer_metrics.common import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx, "decode")
