"""host_frame_share.files: % of the traced window in encode_files'
`host_frame` stage (codec/corpus.py: frame_batches of each file of a group
and the group's concatenation). Bears on the cell's rate, per layer as
encode_MBps.files_traced; names `ratio` as what it moves, the cell's one
other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode_files", "host_frame")
