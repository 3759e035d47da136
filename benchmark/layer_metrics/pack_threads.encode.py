"""pack_threads.encode: the mean number of bitio's worker threads running
over its count and pack passes: the workers' wall seconds summed
(`bitio_workers`, timed in native/bitio.cpp) over the `rice_count` and
`rice_pack` stages' seconds. Moves encode_MBps."""


def read(ctx):
    s = ctx.stage_s
    passes = s.get("rice_count", 0.0) + s.get("rice_pack", 0.0)
    if ctx.op != "encode" or "bitio_workers" not in s or passes <= 0:
        return None
    return s["bitio_workers"] / passes
