"""The one traffic generator: builds a cell's requests from its mix file and
the seed, and runs them through the op that the mix names.

A mix (`mixes/<traffic>.json`) is data: an `op` and its parameters. The op
is code of its own, `ops/<op>.py`, found by that name; it gives

- `setup(t)`: what the op needs beyond the pool (the decode ops' streams),
  kept as `t.state`;
- `request(t, i, metrics) -> dict`: request i, its record: the work it did
  under the keys the end-to-end readers (`e2e_metrics/<metric>.py`) read,
  `track`, and under `out` its output where `t.kept(i)`, else None;
- `checks(t, records) -> {name: (value, limit)}`: each number compared,
  once the window has closed;
- `control() -> [(module, name, replacement)]`: the benchmark's control
  for the op, put in the program's place by `control.py` alone;
- optionally `window(t, seconds, metrics, i) -> (records, failed, next i)`,
  a window of its own (an open loop), in place of the harness's closed loop
  of one caller.

Every op draws its tracks from a pool of `pool_tracks` distinct tracks, made
from the configuration's recipe and the run's seed (`gen/music.py`), taken
in turn from a place the seed picks, so consecutive requests differ. The
outputs of the window's first request of each track, and of a share
`keep_share` of the others drawn from the seed, are kept and checked once
the window has closed; the rest are dropped as a user would drop them.
"""
from __future__ import annotations

import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .gen.music import make_track
from .reference.decode import StreamError, decode as reference_decode

BENCH = os.path.dirname(os.path.abspath(__file__))


def load_named(kind: str, name: str, bench: str = BENCH):
    """The module `<bench>/<kind>/<name>.py`, found by its name."""
    path = os.path.join(bench, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pcm_bytes(cfg: dict) -> int:
    """PCM bytes of one track at the stream's bit depth."""
    n = int(round(cfg["track_seconds"] * cfg["sample_rate"]))
    return n * cfg["channels"] * cfg["bits_per_sample"] // 8


def mismatch(want: list, got: list) -> int:
    """Samples that differ between two lists of channels; a missing
    channel or sample counts as differing."""
    bad = abs(len(want) - len(got)) * max((len(c) for c in want), default=0)
    for a, b in zip(want, got):
        m = min(len(a), len(b))
        bad += abs(len(a) - len(b)) + int(np.count_nonzero(a[:m] != b[:m]))
    return bad


def _reference(buf: bytes):
    """The reference's channels of a stream, or None where it refuses it."""
    try:
        return reference_decode(buf)[2]
    except StreamError:
        return None


def reference_checks(pool: list, todo: list) -> dict:
    """Decode each (track, stream) of `todo` by the reference and compare it
    with the track's PCM: {mismatched_samples, undecodable_streams}."""
    with ThreadPoolExecutor(2) as ex:   # numpy lets go of the GIL
        decoded = list(ex.map(_reference, [buf for _, buf in todo]))
    bad = sum(mismatch(pool[t].channels, c)
              for (t, _), c in zip(todo, decoded) if c is not None)
    return {"mismatched_samples": bad,
            "undecodable_streams": sum(c is None for c in decoded)}


def encode_pool(t) -> list:
    """The pool's tracks, each encoded once by the program: the decode ops'
    streams, made in set-up."""
    from sela_tpu_torch.codec import encoder

    return [encoder.encode_wav(w, profile=t.profile, device=t.device)
            for w in t.pool]


class Traffic:
    """The requests of one cell: set-up, one request, and the checks."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 bench: str = BENCH):
        from sela_tpu_torch.config import BitstreamProfile
        from sela_tpu_torch.ref.wav import WavData

        self.cfg, self.mix, self.device = cfg, mix, device
        self.op_name = mix["op"]
        self.op = load_named("ops", self.op_name, bench)
        self.profile = BitstreamProfile(**cfg["profile"]).validate()
        rng = np.random.default_rng([seed % (1 << 63), 1])
        self.start = int(rng.integers(0, mix["pool_tracks"]))
        self.keep = rng.random(1 << 20) < mix["keep_share"]
        audio = cfg["audio"]
        self.pool = [WavData(cfg["sample_rate"], cfg["bits_per_sample"],
                             make_track(cfg["track_seconds"],
                                        cfg["sample_rate"],
                                        cfg["bits_per_sample"],
                                        audio["recipe_seed"], t, seed, device))
                     for t in range(mix["pool_tracks"])]
        self.state = self.op.setup(self)

    def track(self, i: int) -> int:
        return (self.start + i) % len(self.pool)

    def kept(self, i: int) -> bool:
        """Whether request i's output is kept for the checks: requests
        0..pool-1 warm up, the next pool are the window's first of each
        track."""
        return i < 2 * len(self.pool) or bool(self.keep[i % len(self.keep)])

    def warm_up(self) -> None:
        """Every shape the window uses: one request a pool track."""
        for i in range(len(self.pool)):
            self.request(i, None)

    def request(self, i: int, metrics) -> dict:
        return self.op.request(self, i, metrics)

    def checks(self, records: list, failed: int) -> dict:
        """Each number compared, with its limit: {name: (value, limit)}."""
        return {**self.op.checks(self, records),
                "failed_requests": (failed, 0)}
