"""decode_MBps.traced: PCM bytes (at the stream's depth; MB = 10^6 bytes)
that decode_sela returned in the traced run's window, over the window's
seconds, the stage timer on. The decode rate, kept per layer for its
spread (PERF.md §2); it names `ratio` as what it moves only because that
is the cell's one other end-to-end metric."""


def read(ctx):
    if ctx.op != "decode" or ctx.window_s <= 0:
        return None
    pcm = [r["decoded_pcm"] for r in ctx.records if "decoded_pcm" in r]
    return sum(pcm) / ctx.window_s / 1e6 if pcm else None
