"""The port's streaming decode (codec/stream.py) with a Metrics sink:
decode_stream records its five stages once a chunk, rice_unpack inside
host_unpack, and its counters; StreamingPlayer hands its sink to its
producer, which adds queue_wait and leaves no thread behind once stopped;
no stage is open while a block is yielded; and not a sample changes."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sela_tpu_torch.codec import stream
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.codec.stream import StreamingPlayer, decode_stream
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils.metrics import NULL_METRICS, STAGE, Metrics

FS, CHUNK = 256, 3      # small frames; chunks of 3 frames, the last of 2
N = 7 * FS + 50         # 8 frames, a tail frame of 50 samples
F = -(-N // FS)
CHUNKS = -(-F // CHUNK)
STAGES = ("host_parse", "host_unpack", "device_dispatch", "device_fetch",
          "host_assemble")


def _tone(rng, n: int, amp: float, f: float, noise: float) -> np.ndarray:
    t = np.arange(n)
    return np.round(amp * np.sin(t * f) + rng.normal(0, noise, n)).astype(
        np.int32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(24)
    left = _tone(rng, N, 12000, 0.031, 40)
    w = WavData(44100, 16, [left, left + _tone(rng, N, 300, 0.05, 10)])
    return w, encode_wav(w, frame_size=FS, device="cpu")


def _blocks(buf: bytes, metrics=None) -> list:
    return list(decode_stream(buf, chunk_frames=CHUNK, device="cpu",
                              metrics=metrics))


def _same_blocks(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_a_sink_changes_no_block(case):
    w, buf = case
    traced = _blocks(buf, Metrics())
    _same_blocks(traced, _blocks(buf))
    assert [len(b) for b in traced] == [FS] * (F - 1) + [N - (F - 1) * FS]
    pcm = np.concatenate(traced)
    for c in range(w.n_channels):
        np.testing.assert_array_equal(pcm[:, c], w.channels[c])


def test_stages_and_counters(case):
    w, buf = case
    m = Metrics()
    _blocks(buf, m)
    n, c = m.stage_n, m.counters
    assert set(m.stage_s) == set(STAGES) | {"rice_unpack"}
    assert n["host_parse"] == CHUNKS + 1   # and the trailer
    assert (n["host_unpack"] == n["device_dispatch"] == n["device_fetch"]
            == n["host_assemble"] == CHUNKS)
    assert n["rice_unpack"] == 2 * CHUNKS   # coefficients, residues
    assert m.stage_s["rice_unpack"] <= m.stage_s["host_unpack"]
    assert c["frames"] == c["blocks"] == F and c["chunks"] == CHUNKS
    assert c["int32_wire_chunks"] == 0
    assert c["coded_bytes"] == len(buf)
    assert c["pcm_bytes"] == N * w.n_channels * w.bits_per_sample // 8


def test_stages_nest_as_documented(case, monkeypatch):
    # a stand-in for the device step: only the stages' ranges are read here
    monkeypatch.setattr(stream, "decode_step", lambda res, *args: torch.zeros(
        res.shape, dtype=torch.int32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _blocks(case[1], Metrics())
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith(STAGE):
            ranges.setdefault(e.name[len(STAGE):], []).append(
                (e.time_range.start, e.time_range.end))
    assert set(ranges) == set(STAGES) | {"rice_unpack"}, sorted(ranges)

    def nested(a, b, outer):
        return any(a0 <= a and b <= b0 for a0, b0 in ranges[outer])

    assert all(nested(a, b, "host_unpack") for a, b in ranges["rice_unpack"])
    for name in STAGES:   # the five stages never nest in one another
        for other in set(STAGES) - {name}:
            assert not any(nested(a, b, other) for a, b in ranges[name]), (
                name, other)


def test_null_metrics_records_nothing(case):
    _blocks(case[1], NULL_METRICS)
    list(StreamingPlayer(case[1], chunk_frames=CHUNK, device="cpu"))
    assert NULL_METRICS.counters == {} and NULL_METRICS.stage_s == {}


def test_no_stage_holds_the_consumers_time(case):
    """The consumer sleeps between blocks: the stages' seconds stay within
    the wall time the consumer did not sleep."""
    m = Metrics()
    slept = 0.0
    t0 = time.perf_counter()
    for _ in decode_stream(case[1], chunk_frames=CHUNK, device="cpu",
                           metrics=m):
        t = time.perf_counter()
        time.sleep(0.02)
        slept += time.perf_counter() - t
    wall = time.perf_counter() - t0
    top = sum(m.stage_s[s] for s in STAGES)
    assert slept >= 0.02 * F
    assert top <= wall - slept + 1e-3, (top, wall, slept)


def test_stopped_player_leaves_no_thread(case):
    """A player stopped after its first chunk's blocks: its producer is
    gone, it decoded at least the frames taken, and it waited on the
    full queue."""
    m = Metrics()
    before = threading.active_count()
    player = StreamingPlayer(case[1], chunk_frames=CHUNK, max_blocks=1,
                             device="cpu", metrics=m)
    taken = []
    for block in player:
        taken.append(block)
        if len(taken) == CHUNK:
            break
        time.sleep(0.02)   # the producer fills the queue meanwhile
    player.stop()
    assert not player._thread.is_alive()
    assert threading.active_count() == before
    _same_blocks(taken, _blocks(case[1])[:CHUNK])
    c = m.counters
    assert c["frames"] >= len(taken) and c["blocks"] >= len(taken)
    assert c["frames"] < F and c["chunks"] < CHUNKS   # stopped early
    assert 1 <= m.stage_n["queue_wait"] <= c["blocks"]
    # the put of block 3 waits out most of the consumer's sleep after block 2
    assert m.stage_s["queue_wait"] >= 0.01


def test_player_records_the_whole_stream(case):
    """A queue that never fills: every stage but queue_wait, which only a
    put that finds the queue full records."""
    w, buf = case
    m = Metrics()
    played = list(StreamingPlayer(buf, chunk_frames=CHUNK, max_blocks=F,
                                  device="cpu", metrics=m))
    _same_blocks(played, _blocks(buf))
    c = m.counters
    assert c["frames"] == c["blocks"] == F and c["chunks"] == CHUNKS
    assert c["coded_bytes"] == len(buf)
    assert set(m.stage_s) == set(STAGES) | {"rice_unpack"}
