"""dispatch_share.files: % of the traced window in encode_files'
`device_dispatch` stage (codec/corpus.py: each chunk's copy to the card and
encode_step's launches). Bears on the cell's rate, per layer as
encode_MBps.files_traced; names `ratio` as what it moves, the cell's one
other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode_files", "device_dispatch")
