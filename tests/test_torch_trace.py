"""The port's spans inside `host_pack`: the stages pack_gather, rice_count,
rice_pack and emit, bitio's worker threads timed in the native library,
and the stages as torch.profiler ranges. A sink changes no byte."""
from __future__ import annotations

import os
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.format import RICE_PARTITION_MARKER
from sela_tpu_torch.native import bitio
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils.metrics import NULL_METRICS, STAGE, Metrics

SPANS = ("pack_gather", "rice_count", "rice_pack", "emit")
FS = 32   # small frames: many blocks a native call at little encode cost


def _clip(frames: int, seed: int) -> WavData:
    rng = np.random.default_rng(seed)
    n = FS * frames - 5
    t = np.arange(n)
    chans = [np.round(4000 * np.sin(t * f) + rng.normal(0, 60, n))
             .astype(np.int32) for f in (0.05, 0.031)]
    return WavData(44100, 16, chans)


def _encode(w: WavData, metrics) -> bytes:
    return encode_wav(w, frame_size=FS, device="cpu", metrics=metrics)


def _thread_clock_step() -> float:
    """The smallest step seen of this host's thread CPU clock (the one
    bitio's workers read): about a microsecond on most hosts, a 10 ms tick
    on tick-based kernels."""
    step, last = 1.0, time.thread_time()
    deadline = time.perf_counter() + 0.2
    for _ in range(3):
        while (now := time.thread_time()) == last:
            if time.perf_counter() > deadline:
                return step
        step, last = min(step, now - last), now
    return step


def _within_the_clock(m: Metrics) -> bool:
    """Workers' on-CPU seconds no more than their wall, to within a step of
    the thread CPU clock a worker."""
    s, slack = m.stage_s, m.stage_n["bitio_workers"] * _thread_clock_step()
    return s["bitio_workers_on_cpu"] <= s["bitio_workers"] + slack + 1e-5


@pytest.fixture(scope="module")
def threaded():
    """A stereo clip whose native calls take bitio's threaded path (at
    least 4 blocks a hardware thread, parallel_for in bitio.cpp), encoded
    with a Metrics sink."""
    w = _clip(4 * (os.cpu_count() or 2) + 3, seed=3)
    m = Metrics()
    return w, _encode(w, m), m


def test_a_sink_changes_no_byte(threaded):
    w, buf, _ = threaded
    assert _encode(w, None) == buf
    assert _encode(w, NULL_METRICS) == buf


def test_pack_spans_lie_inside_host_pack(threaded):
    _, _, m = threaded
    assert all(m.stage_n.get(name) for name in SPANS), m.stage_n
    assert sum(m.stage_s[name] for name in SPANS) <= m.stage_s["host_pack"]
    chunks = m.stage_n["host_pack"]
    # one gather before each block kind's native calls; one emit a chunk;
    # one assembly of the stream, after the chunks
    assert m.stage_n["pack_gather"] == 2 * chunks
    assert m.stage_n["rice_count"] == m.stage_n["rice_pack"] == 2 * chunks
    assert m.stage_n["emit"] == chunks
    assert m.stage_n["host_assemble"] == 1


def test_threaded_workers_are_timed(threaded):
    _, _, m = threaded
    calls = m.stage_n["rice_count"] + m.stage_n["rice_pack"]
    assert m.stage_n["bitio_workers"] == m.stage_n["bitio_workers_on_cpu"]
    assert m.stage_n["bitio_workers"] > calls   # more than one worker a call
    assert m.stage_s["bitio_workers"] > 0
    assert m.stage_s["bitio_workers_on_cpu"] >= 0 and _within_the_clock(m)


def test_workers_on_cpu_time_of_a_long_pack():
    """Enough work for every worker to see the thread CPU clock move even
    where it steps by 10 ms: 4 M values, ~20 ns a value a pass."""
    rng = np.random.default_rng(7)
    blocks = 16 * (os.cpu_count() or 2)
    n = (1 << 22) // blocks
    values = np.round(rng.laplace(0, 300, blocks * n)).astype(np.int32)
    m = Metrics()
    bitio.pack_blocks_flat(values, np.arange(blocks, dtype=np.int64) * n,
                           np.full(blocks, n, np.int32),
                           np.full(blocks, 8, np.int32), metrics=m)
    assert m.stage_s["bitio_workers_on_cpu"] > 0 and _within_the_clock(m)


def test_serial_path_records_one_worker_a_call():
    m = Metrics()
    _encode(_clip(3, seed=4), m)   # 6 blocks a call: under 4 a thread
    calls = m.stage_n["rice_count"] + m.stage_n["rice_pack"]
    assert calls == 4
    assert m.stage_n["bitio_workers"] == calls
    assert 0 < m.stage_s["bitio_workers"] <= (m.stage_s["rice_count"]
                                             + m.stage_s["rice_pack"])


def test_stages_are_profiler_ranges_nested_in_host_pack():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _encode(_clip(3, seed=5), Metrics())
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith(STAGE):
            ranges.setdefault(e.name[len(STAGE):], []).append(
                (e.time_range.start, e.time_range.end))
    outer = ranges["host_pack"]
    for name in ("rice_pack", "pack_gather"):
        assert ranges.get(name), sorted(ranges)
        for a, b in ranges[name]:
            assert any(a0 <= a and b <= b0 for a0, b0 in outer), name


def test_pack_blocks_flat_words_with_and_without_a_sink():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 300, 64).astype(np.int32)
    values = np.round(rng.laplace(0, 200, int(counts.sum()))).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int64)
    ks = rng.integers(0, 12, 64).astype(np.int32)
    ks[::5] = RICE_PARTITION_MARKER
    ks4 = rng.integers(0, 12, (64, 4)).astype(np.int32)
    ks4 = ks4[:, 0] | ks4[:, 1] << 8 | ks4[:, 2] << 16 | ks4[:, 3] << 24
    want = bitio.pack_blocks_flat(values, offs, counts, ks, ks4)
    m = Metrics()
    for sink in (NULL_METRICS, m):
        words, word_counts = bitio.pack_blocks_flat(values, offs, counts, ks,
                                                    ks4, metrics=sink)
        np.testing.assert_array_equal(words, want[0])
        np.testing.assert_array_equal(word_counts, want[1])
    assert m.stage_n["rice_count"] == m.stage_n["rice_pack"] == 1
    assert m.stage_n["bitio_workers"] >= 2
    assert NULL_METRICS.stage_s == {} and NULL_METRICS.stage_n == {}


def test_add_span_adds_seconds_and_spans():
    m = Metrics()
    m.add_span("w", 0.5, n=8)
    m.add_span("w", 0.25)
    assert (m.stage_s["w"], m.stage_n["w"]) == (0.75, 9)
    NULL_METRICS.add_span("w", 1.0, n=2)
    assert "w" not in NULL_METRICS.stage_s
