"""play: a player started on a pool stream and skipped after `play_frames`
frames, one stream after another.

Set-up encodes each pool track once with the program's `encode_wav` under
the cell's profile (traffic.encode_pool). Request i constructs the
program's `StreamingPlayer` on the stream of track `t.track(i)`, with the
configuration's `chunk_frames` and `max_blocks`, takes blocks at full
speed until `play_frames` have been taken (the listener's skip), then calls
`stop()` and looks whether the producer thread is still alive. A sink is
handed to the player only where one is given and the program's player
takes one, so that a program without the player's spans runs the cell
too, traced or not, and reports none of them.

Record: `track`; `coded` (the stream's bytes) and `encoded_pcm` (the
track's PCM bytes, at its depth), which `ratio` reads: what the archive
stores; `played_frames` (blocks taken); `played_pcm` (their bytes at the
configuration's depth); `first_s` (seconds from the player's construction
to its first block; None where it gave none); `live` (the producer alive
after `stop()`); `header` (the player's rate, depth and channel count);
`counters` (the request's program counters, where a sink was handed over,
else None); `out` (the blocks taken, where kept, else None). Each distinct
kept output is held once a track.

Checks, once the window has closed, each limit 0: every distinct kept
output, concatenated, against its track's first `play_frames` frames of
PCM (`mismatched_samples`); kept requests whose block count or any block's
shape differs from the reference's played blocks (`block_mismatches`,
reference/play.py); requests whose player's header differs from the
configuration's rate, depth and channels (`header_mismatches`); requests
that took fewer than `play_frames` blocks (`short_plays`); producer
threads alive after `stop()` (`live_players`); and the pool's streams
decoded by the plain reference against the PCM (`stream_mismatches`,
`undecodable_streams`). Control: the program's `decode_stream` with the
lowest bit of every block's samples cleared (a lossy player), which the
player's producer looks up when it starts."""
from __future__ import annotations

import inspect
import time
from types import SimpleNamespace

import numpy as np

from benchmark.reference.play import played_blocks
from benchmark.traffic import (encode_pool, mismatch, pcm_bytes,
                               reference_checks)


def _stream():
    from sela_tpu_torch.codec import stream   # looked up at call time

    return stream


def setup(t):
    """The pool's streams, and each track's distinct outputs held."""
    return SimpleNamespace(streams=encode_pool(t),
                           held={k: [] for k in range(len(t.pool))})


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def _hold(t, track: int, blocks: list) -> list:
    """`blocks`, or the output held for `track` that equals it."""
    held = t.state.held[track]
    for h in held:
        if _same(h, blocks):
            return h
    held.append(blocks)
    return blocks


def request(t, i, metrics):
    stream = _stream()
    track = t.track(i)
    buf = t.state.streams[track]
    want = t.mix["play_frames"]
    kw = {}
    if metrics is not None and "metrics" in inspect.signature(
            stream.StreamingPlayer).parameters:
        kw["metrics"] = metrics
    before = dict(metrics.counters) if kw else None
    blocks, first = [], None
    t0 = time.perf_counter()
    player = stream.StreamingPlayer(buf, chunk_frames=t.cfg["chunk_frames"],
                                    max_blocks=t.cfg["max_blocks"],
                                    device=t.device, **kw)
    try:
        for block in player:
            if first is None:
                first = time.perf_counter() - t0
            blocks.append(block)
            if len(blocks) == want:
                break
    finally:
        player.stop()
    live = player._thread.is_alive()
    counters = None if before is None else {
        k: v - before.get(k, 0) for k, v in metrics.counters.items()}
    h = player.header
    return dict(track=track, coded=len(buf), encoded_pcm=pcm_bytes(t.cfg),
                played_frames=len(blocks),
                played_pcm=sum(b.size for b in blocks)
                * t.cfg["bits_per_sample"] // 8,
                first_s=first, live=live,
                header=(h.sample_rate, h.bits_per_sample, h.channels),
                counters=counters,
                out=_hold(t, track, blocks) if t.kept(i) else None)


def checks(t, records):
    frames = t.mix["play_frames"]
    n = frames * t.cfg["profile"]["frame_size"]
    outs = {}   # id -> (track, the distinct kept output)
    for r in records:
        if r["out"] is not None:
            outs.setdefault(id(r["out"]), (r["track"], r["out"]))
    ref = {k: played_blocks(t.state.streams[k], frames)
           for k in {k for k, _ in outs.values()}}
    bad = sum(mismatch([c[:n] for c in t.pool[k].channels],
                       list(np.concatenate(b).T) if b else [])
              for k, b in outs.values())
    shaped = {key: len(b) != len(ref[k]) or any(
        x.shape != y.shape for x, y in zip(b, ref[k]))
        for key, (k, b) in outs.items()}
    blocks = sum(shaped[id(r["out"])] for r in records
                 if r["out"] is not None)
    cfg = t.cfg
    want = cfg["sample_rate"], cfg["bits_per_sample"], cfg["channels"]
    streams = reference_checks(t.pool, list(enumerate(t.state.streams)))
    return {"mismatched_samples": (bad, 0),
            "block_mismatches": (blocks, 0),
            "header_mismatches": (sum(r["header"] != want for r in records),
                                  0),
            "short_plays": (sum(r["played_frames"] < frames
                                for r in records), 0),
            "live_players": (sum(r["live"] for r in records), 0),
            "stream_mismatches": (streams["mismatched_samples"], 0),
            "undecodable_streams": (streams["undecodable_streams"], 0)}


def control():
    stream = _stream()
    sound = stream.decode_stream

    def lossy(buf, *args, **kw):
        for block in sound(buf, *args, **kw):
            yield block & ~1

    return [(stream, "decode_stream", lossy)]
