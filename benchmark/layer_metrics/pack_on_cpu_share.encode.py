"""pack_on_cpu_share.encode: % of the lives of bitio's count and pack
workers spent on a CPU: their on-CPU seconds (`bitio_workers_on_cpu`,
CLOCK_THREAD_CPUTIME_ID) over their wall seconds (`bitio_workers`), both
timed in native/bitio.cpp. A worker waiting for a core lowers it. Moves
encode_MBps."""


def read(ctx):
    s = ctx.stage_s
    if (ctx.op != "encode" or "bitio_workers_on_cpu" not in s
            or s.get("bitio_workers", 0.0) <= 0):
        return None
    return 100.0 * s["bitio_workers_on_cpu"] / s["bitio_workers"]
