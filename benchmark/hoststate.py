"""The host's state around a run's window, printed on the run's standard
error: the CPU's busy and stolen shares over the window (/proc/stat; steal
is time the hypervisor gave this machine's vCPUs to others), its clock
(/proc/cpuinfo), its load (/proc/loadavg), its CPUs and the run's, the
threads that the program's native bit I/O starts a call
(`std::thread::hardware_concurrency`, which is glibc's `get_nprocs`), and
the seconds that a fixed piece of host work takes just before and just
after the window: a numpy sort on one thread, and a Rice pack of fixed
residues through the program's threaded bit I/O, the code that most of the
window runs. Where the kernel reports no steal and a fixed clock,
those two times are what shows the host's speed.
"""
from __future__ import annotations

import ctypes
import os
import time

import numpy as np

def probe() -> tuple[float, float]:
    """Seconds of (a one-thread sort, a threaded Rice pack) of fixed data."""
    from sela_tpu_torch.native import bitio

    data = np.random.default_rng(0).laplace(0, 300, 1 << 21).astype(np.int32)
    t0 = time.perf_counter()
    np.sort(data[: 1 << 20], kind="stable")
    t1 = time.perf_counter()
    n = len(data) // 2048
    offs = np.arange(n, dtype=np.int64) * 2048
    for _ in range(3):
        bitio.pack_blocks_flat(data, offs, np.full(n, 2048, np.int32),
                               np.full(n, 8, np.int32))
    return t1 - t0, time.perf_counter() - t1


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def sample() -> dict:
    """The probe's seconds, then the CPU's tick counters and clock."""
    sort_s, pack_s = probe()
    ticks = [int(v) for v in _read("/proc/stat").split("\n")[0].split()[1:]]
    mhz = [float(line.split(":")[1]) for line in
           _read("/proc/cpuinfo").splitlines() if line.startswith("cpu MHz")]
    return {"ticks": ticks, "mhz": sum(mhz) / len(mhz) if mhz else None,
            "sort_s": sort_s, "pack_s": pack_s}


def describe(before: dict, after: dict) -> str:
    """One line: the window's CPU shares, clock, load and threads."""
    d = [b - a for a, b in zip(before["ticks"], after["ticks"])]
    total = sum(d[:8]) or 1   # user nice system idle iowait irq softirq steal
    busy = (total - d[3] - d[4]) / total if len(d) >= 8 else None
    steal = d[7] / total if len(d) >= 8 else None
    try:
        nprocs = ctypes.CDLL(None).get_nprocs()
    except (OSError, AttributeError):
        nprocs = None
    load = " ".join(_read("/proc/loadavg").split()[:3])
    fmt = (lambda v: "?" if v is None else f"{v:.4f}")
    return (f"host: cpu busy {fmt(busy)} steal {fmt(steal)} of the window; "
            f"MHz {fmt(before['mhz'])} -> {fmt(after['mhz'])}; loadavg "
            f"{load}; cpus {os.cpu_count()}, affinity "
            f"{len(os.sched_getaffinity(0))}; bitio threads {nprocs}; probe "
            f"sort {before['sort_s']:.5f} -> {after['sort_s']:.5f} s, pack "
            f"{before['pack_s']:.5f} -> {after['pack_s']:.5f} s")
