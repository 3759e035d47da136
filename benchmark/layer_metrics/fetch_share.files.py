"""fetch_share.files: % of the traced window in encode_files' `device_fetch`
stage (codec/corpus.py: the synchronous fetch of each chunk's plan and
residues, the wait for the card included, which encode_wav hides behind
later chunks and encode_files does not). Bears on the cell's rate, per
layer as encode_MBps.files_traced; names `ratio` as what it moves, the
cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "encode_files", "device_fetch")
