"""device_idle_share.encode: % of the profiled stretch in which the card ran
no kernel and no copy. Moves encode_MBps."""
from benchmark.layer_metrics.common import idle_share


def read(ctx):
    return idle_share(ctx, "encode")
