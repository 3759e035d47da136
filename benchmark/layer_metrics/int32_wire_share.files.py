"""int32_wire_share.files: % of encode_files' device chunks in the traced
window whose residues came back as int32, not every frame's fitting the
int16 wire: the program's counters `int32_fetch` over `chunks`
(codec/corpus.py), which the op puts into each request's record. Bears on
the cell's rate, per layer as encode_MBps.files_traced; names `ratio` as
what it moves, the cell's one other end-to-end metric (PERF.md §2)."""


def read(ctx):
    if ctx.op != "encode_files":
        return None
    counted = [r["counters"] for r in ctx.records
               if r.get("counters") and "chunks" in r["counters"]]
    chunks = sum(c["chunks"] for c in counted)
    if not chunks:
        return None
    return 100.0 * sum(c.get("int32_fetch", 0) for c in counted) / chunks
