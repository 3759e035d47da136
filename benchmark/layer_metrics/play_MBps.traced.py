"""play_MBps.traced: the PCM bytes of the blocks the players yielded and
the listener took in the traced run's window (the play op's `played_pcm`,
at the stream's depth; MB = 10^6 bytes), over the window's seconds, the
stage timer on. The rate a listener who skips is served at, per layer as
decode_MBps.traced (PERF.md §2); names `ratio` as what it moves only
because that is the cell's one other end-to-end metric."""


def read(ctx):
    if ctx.op != "play" or ctx.window_s <= 0:
        return None
    pcm = [r["played_pcm"] for r in ctx.records if "played_pcm" in r]
    return sum(pcm) / ctx.window_s / 1e6 if pcm else None
