"""The play cell, cd16_v1.play, at a size a test run can hold (3-s tracks,
8-frame chunks, 24 frames played): plain and traced runs come out correct,
the traced line reports every reader the CPU can give, the control and
planted faults (a stale first block, a dropped block, an altered header
rate, a player never stopped, a block split in two) come out caught, a
program whose player takes no sink runs the cell traced too, the readers
read nothing off their op, and the reference's played blocks are the
PCM's frames."""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from benchmark.control import controlled
from benchmark.reference.play import played_blocks
from benchmark.traffic import load_named
from conftest import ROOT

CELL = "cd16_v1.play"
SIZES = {"config": {"track_seconds": 3.0, "chunk_frames": 8},
         "mix": {"trace_requests": 2, "keep_share": 1.0, "play_frames": 24}}
STAGES = ("host_parse_share.play", "host_unpack_share.play",
          "dispatch_share.play", "fetch_share.play", "assemble_share.play")
HOST_CLOCK = ("first_audio_ms_p50.play", "first_audio_ms_p95.play",
              "play_MBps.traced")
ON_THE_CPU = STAGES + HOST_CLOCK + ("decoded_per_played.play",)
ON_THE_CARD = ("device_idle_share.play",)
CHECKS = {"mismatched_samples", "block_mismatches", "header_mismatches",
          "short_plays", "live_players", "stream_mismatches",
          "undecodable_streams", "failed_requests"}


def _run(seed, trace):
    return harness.run_cell(CELL, seed, 0.3, trace, time.perf_counter(),
                            device="cpu", sizes=SIZES)


def _value(out, check):
    return out["checks"][check]["value"]


def test_plain_run_is_correct():
    out = _run(2147483659, False)
    assert out["correct"], out["checks"]
    # first audio spreads too widely for a bound: per layer only
    assert set(out["metrics"]) == {"ratio", "setup_s"}
    assert set(out["checks"]) == CHECKS
    assert 0 < out["metrics"]["ratio"]["value"] < 1


def test_traced_line_reports_what_the_cpu_gives():
    out = _run(7, True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(ON_THE_CPU), sorted(got)
    shares = [got[k] for k in STAGES]
    assert all(0 <= s <= 100 for s in shares) and sum(shares) <= 100
    assert 0 < got["first_audio_ms_p50.play"] <= got[
        "first_audio_ms_p95.play"]
    assert got["play_MBps.traced"] > 0
    # 24 frames played are 3 chunks of 8: the read-ahead is one chunk
    assert got["decoded_per_played.play"] == pytest.approx(32 / 24)


def test_spec_lists_every_reader_for_the_cell():
    e2e, layer = harness.cell_metrics(harness.load_spec(), CELL)
    assert {m["name"] for m in e2e} == {"ratio", "setup_s"}
    assert {m["name"] for m in layer} == set(ON_THE_CPU + ON_THE_CARD)


def test_control_is_not_correct():
    with controlled(CELL):
        out = _run(1, False)
    assert not out["correct"]
    assert _value(out, "mismatched_samples") > 0
    # the streams are sound, the blocks whole: the player alone is wrong
    for check in ("stream_mismatches", "block_mismatches",
                  "header_mismatches", "short_plays", "live_players"):
        assert _value(out, check) == 0, check


def test_control_puts_the_program_back():
    from sela_tpu_torch.codec import stream

    sound = stream.decode_stream
    with controlled(CELL):
        assert stream.decode_stream is not sound
    assert stream.decode_stream is sound


def _planted_stream(sound, fault: str):
    """decode_stream with `fault` planted in the blocks it yields."""
    firsts = []

    def run(buf, *args, **kw):
        for i, block in enumerate(sound(buf, *args, **kw)):
            if i == 0 and fault == "stale":   # the previous request's
                firsts.append(block)
                block = firsts[-2] if len(firsts) > 1 else block
            if i == 1 and fault == "dropped":
                continue
            if i == 2 and fault == "split":
                yield block[: len(block) // 2]
                block = block[len(block) // 2:]
            yield block

    return run


def _planted_player(sound, fault: str, started: list):
    class Player(sound):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            started.append(self)
            if fault == "rate":
                self.header = dataclasses.replace(self.header,
                                                  sample_rate=48000)

        def stop(self):
            if fault != "unstopped":
                super().stop()

    return Player


FAULTS = {"stale": "mismatched_samples", "dropped": "mismatched_samples",
          "split": "block_mismatches", "rate": "header_mismatches",
          "unstopped": "live_players"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    from sela_tpu_torch.codec import stream

    started = []
    if fault in ("rate", "unstopped"):
        monkeypatch.setattr(stream, "StreamingPlayer", _planted_player(
            stream.StreamingPlayer, fault, started))
    else:
        monkeypatch.setattr(stream, "decode_stream",
                            _planted_stream(stream.decode_stream, fault))
    try:
        out = _run(3, False)
    finally:
        for player in started:   # no thread outlives the test
            player.queue.abort()
            player._thread.join()
    assert not out["correct"], out["checks"]
    assert _value(out, FAULTS[fault]) > 0
    assert _value(out, "stream_mismatches") == 0
    if fault == "unstopped":   # every player was left running
        assert _value(out, "live_players") == out["attempted"]
        assert _value(out, "mismatched_samples") == 0
    if fault == "rate":
        assert _value(out, "mismatched_samples") == 0


def test_a_player_without_a_sink_runs_traced(monkeypatch):
    """A program whose StreamingPlayer takes no `metrics` (as before the
    player had spans) runs the traced cell correct, and the line holds the
    host clock's readers alone."""
    from sela_tpu_torch.codec import stream

    sound = stream.StreamingPlayer

    class Plain(sound):
        def __init__(self, buf, chunk_frames=128, max_blocks=32,
                     device=None):
            super().__init__(buf, chunk_frames, max_blocks, device)

    monkeypatch.setattr(stream, "StreamingPlayer", Plain)
    out = _run(5, True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(HOST_CLOCK)


STAGE_S = {"host_parse": 0.1, "host_unpack": 1.0, "rice_unpack": 0.4,
           "device_dispatch": 0.2, "device_fetch": 0.3, "host_assemble": 0.2,
           "queue_wait": 0.1}


def _ctx(op="play", stage_s=STAGE_S, records=()):
    return SimpleNamespace(op=op, records=list(records), window_s=2.0,
                           stage_s=dict(stage_s), trace=None,
                           stretch_bytes=0, peak_bytes_per_s=None)


def _read(name, ctx):
    return load_named("layer_metrics", name).read(ctx)


def test_reader_values():
    ctx = _ctx(records=[
        {"first_s": 0.010 * k, "played_pcm": 1_000_000, "played_frames": 4,
         "counters": {"frames": 6}} for k in range(1, 22)] + [
        {"first_s": None, "played_pcm": 0, "played_frames": 0,
         "counters": None}])
    for name, stage in zip(STAGES, ("host_parse", "host_unpack",
                                    "device_dispatch", "device_fetch",
                                    "host_assemble")):
        assert _read(name, ctx) == pytest.approx(100 * STAGE_S[stage] / 2.0)
    assert _read("first_audio_ms_p50.play", ctx) == pytest.approx(110.0)
    assert _read("first_audio_ms_p95.play", ctx) == pytest.approx(200.0)
    assert _read("play_MBps.traced", ctx) == pytest.approx(10.5)
    assert _read("decoded_per_played.play", ctx) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ON_THE_CPU + ON_THE_CARD)
def test_readers_read_nothing_off_their_op(name):
    decode = [{"decoded_pcm": 10, "first_s": 0.1, "played_pcm": 10,
               "played_frames": 1, "counters": {"frames": 1}}]
    assert _read(name, _ctx(op="decode", records=decode)) is None
    # what a program without the player's spans and counters records
    assert name in HOST_CLOCK or _read(name, _ctx(stage_s={}, records=[
        {"first_s": 0.1, "played_pcm": 10, "played_frames": 1,
         "counters": None}])) is None
    assert _read(name, _ctx(stage_s={}, records=[])) is None


def test_reference_blocks_are_the_frames():
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(24)
    n = 5 * 256 + 70
    chans = [np.round(9000 * np.sin(np.arange(n) * f)
                      + rng.normal(0, 30, n)).astype(np.int32)
             for f in (0.03, 0.05)]
    buf = encode_wav(WavData(44100, 16, chans), frame_size=256, device="cpu")
    pcm = np.stack(chans, axis=1)
    for frames, lens in ((4, [256] * 4), (6, [256] * 5 + [70]),
                         (9, [256] * 5 + [70])):
        blocks = played_blocks(buf, frames)
        assert [b.shape for b in blocks] == [(k, 2) for k in lens]
        assert all(b.dtype == np.int32 for b in blocks)
        np.testing.assert_array_equal(np.concatenate(blocks),
                                      pcm[:sum(lens)])


def test_reference_imports_numpy_and_the_reference_only():
    tree = ast.parse(open(os.path.join(ROOT, "benchmark", "reference",
                                       "play.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    assert names <= {"__future__", "numpy", ".decode"}
    probe = ("import sys, json\nfrom benchmark.reference import play\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "sela_tpu",
                         "sela_tpu_torch", "torch"}
