"""host_parse_share.decode: % of the traced window in decode_sela's
`host_parse` stage (codec/decoder.py::scan: the native container scan, and
the trailer). Bears on the decode rate, per layer as decode_MBps.traced;
names `ratio` as what it moves, nominally: the cell's one other end-to-end
metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "host_parse")
