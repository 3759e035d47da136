"""int32_wire_share.decode: % of decode_sela's chunks in the traced window
whose residues crossed to the card on the int32 wire, not every value
fitting int16: the program's counters `int32_wire_chunks` over `chunks`
(codec/decoder.py), which the op puts into each request's record. Bears
on the decode rate, per layer as decode_MBps.traced; names `ratio` as what
it moves, nominally: the cell's one other end-to-end metric (PERF.md
§2)."""


def read(ctx):
    if ctx.op != "decode":
        return None
    counted = [r["counters"] for r in ctx.records
               if r.get("counters") and "chunks" in r["counters"]]
    chunks = sum(c["chunks"] for c in counted)
    if not chunks:
        return None
    return 100.0 * sum(c.get("int32_wire_chunks", 0)
                       for c in counted) / chunks
