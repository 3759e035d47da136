"""bitio_share.files: % of the traced window in bitio's two native passes
under encode_files, `rice_count` + `rice_pack`
(native/bitio.py::pack_blocks_flat), inside `host_pack`. Bears on the
cell's rate, per layer as encode_MBps.files_traced; names `ratio` as what
it moves, the cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    shares = [stage_share(ctx, "encode_files", s)
              for s in ("rice_count", "rice_pack")]
    return None if None in shares else sum(shares)
