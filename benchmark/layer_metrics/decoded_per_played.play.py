"""decoded_per_played.play: the frames decode_stream decoded (the program's
counter `frames`, which the play op puts into each request's record) over
the frames the listener took (`played_frames`), summed over the traced
window's requests: 1 plus the read-ahead that the skip throws away (the
player decodes whole chunks and cannot stop inside one). Names `ratio` as
what it moves, nominally: the cell's one other end-to-end metric (PERF.md
§2)."""


def read(ctx):
    if ctx.op != "play":
        return None
    counted = [r for r in ctx.records
               if r.get("counters") and "frames" in r["counters"]]
    played = sum(r["played_frames"] for r in counted)
    if not played:
        return None
    return sum(r["counters"]["frames"] for r in counted) / played
