"""rice_unpack_share.decode: % of the traced window in decode_sela's
`rice_unpack` stage (native/bitio.py::unpack_blocks_flat, the coefficients'
and the residues' unpack, inside host_unpack). Bears on the decode rate,
per layer as decode_MBps.traced; names `ratio` as what it moves, nominally:
the cell's one other end-to-end metric (PERF.md §2)."""
from benchmark.layer_metrics.common import stage_share


def read(ctx):
    return stage_share(ctx, "decode", "rice_unpack")
