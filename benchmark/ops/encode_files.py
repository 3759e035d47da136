"""encode_files: the corpus batch codec's `encode_files` of one batch of
mixed files a request.

Set-up builds `pool_tracks` distinct batches from the configuration's
`batch`: each file's length, rate, depth and channel count from the
recipe seed, so every run encodes the same multiset of formats; its audio
from `gen/music.py` (a mono file takes the left channel), the run's seed
drawing the notes' order, phases and noise. Request i encodes batch
`t.track(i)` at the mix's `chunk_frames` and the profile's frame size.

Record: `encoded_pcm` (the batch's PCM bytes, each file at its own depth),
`coded` (the streams' bytes), `track`, `streams` (how many streams came
back), `out` (the list of streams, where kept) and `counters` (the
request's program counters, where a sink was passed, else None). Checks:
every request returns one stream a file of its batch; every distinct kept
stream is decoded by the reference and compared with its file's PCM and
header. Control: the
program's `encode_files` of the PCM with its lowest bit cleared (a lossy
encoder)."""
from __future__ import annotations

import hashlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from benchmark.gen.music import make_track
from benchmark.reference.decode import StreamError, decode
from benchmark.traffic import mismatch


def _encode_files():
    from sela_tpu_torch.codec import corpus   # looked up at call time

    return corpus.encode_files


def make_batch(cfg: dict, batch: int, seed: int, device) -> list:
    """Batch `batch` of the configuration: WavData files whose formats the
    recipe seed draws and whose audio the run's seed draws."""
    from sela_tpu_torch.ref.wav import WavData

    spec, recipe_seed = cfg["batch"], cfg["audio"]["recipe_seed"]
    draw = np.random.default_rng([recipe_seed, 1 << 32, batch])
    wavs = []
    for j in range(spec["files"]):
        secs = float(draw.uniform(*spec["seconds"]))
        rate = int(draw.choice(spec["sample_rates"]))
        bits = int(draw.choice(spec["bits"]))
        nch = int(draw.choice(spec["channels"]))
        chans = make_track(secs, rate, bits, recipe_seed,
                           batch * spec["files"] + j, seed, device)
        wavs.append(WavData(rate, bits, chans[:nch]))
    return wavs


def run_seed(t) -> int:
    """A seed drawn from the run's: the traffic keeps no seed of its own,
    but its keep draws come from the run's seed alone."""
    digest = hashlib.sha256(np.packbits(t.keep).tobytes()).digest()
    return int.from_bytes(digest[:8], "little")


def setup(t):
    from sela_tpu_torch.config import BitstreamProfile

    default = BitstreamProfile(frame_size=t.profile.frame_size)
    if t.profile != default:
        raise ValueError(f"encode_files encodes the default profile at a "
                         f"frame size, not {t.profile}")
    seed = run_seed(t)
    return [make_batch(t.cfg, b, seed, t.device) for b in range(len(t.pool))]


def request(t, i, metrics):
    track = t.track(i)
    wavs = t.state[track]
    before = dict(metrics.counters) if metrics is not None else None
    bufs = _encode_files()(wavs, chunk_frames=t.mix["chunk_frames"],
                           frame_size=t.profile.frame_size, device=t.device,
                           metrics=metrics)
    counters = None if metrics is None else {
        k: v - before.get(k, 0) for k, v in metrics.counters.items()}
    pcm = sum(w.n_samples * w.n_channels * w.bits_per_sample // 8
              for w in wavs)
    return dict(track=track, encoded_pcm=pcm,
                coded=sum(len(b) for b in bufs), streams=len(bufs),
                counters=counters, out=bufs if t.kept(i) else None)


def _reference(futures) -> list:
    """(rate, bits, channels) of each stream by the reference, or None
    where it refuses it."""
    out = []
    for f in futures:
        try:
            out.append(f.result())
        except StreamError:
            out.append(None)
    return out


def checks(t, records):
    # a file with no stream, or a stream with no file, in any request
    missing = sum(abs(len(t.state[r["track"]]) - r["streams"])
                  for r in records)
    todo = {}   # (batch, file) -> the distinct streams kept for it
    for r in records:
        for j, buf in enumerate((r["out"] or ())[:len(t.state[r["track"]])]):
            seen = todo.setdefault((r["track"], j), [])
            if not any(buf == s for s in seen):
                seen.append(buf)
    pairs = [(key, buf) for key, bufs in todo.items() for buf in bufs]
    # processes: the reference's loops over a short stream's samples hold
    # the GIL, and a batch's streams are many and short
    with ProcessPoolExecutor(
            max(1, min(len(pairs), os.cpu_count() or 1, 8)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        decoded = _reference([ex.submit(decode, buf) for _, buf in pairs])
    bad = headers = 0
    for ((batch, j), _), got in zip(pairs, decoded):
        if got is None:
            continue
        w = t.state[batch][j]
        rate, bits, chans = got
        headers += (rate, bits, len(chans)) != (
            w.sample_rate, w.bits_per_sample, w.n_channels)
        bad += mismatch(w.channels, chans)
    return {"mismatched_samples": (bad, 0),
            "undecodable_streams": (sum(g is None for g in decoded), 0),
            "header_mismatches": (headers, 0),
            "missing_streams": (missing, 0)}


def control():
    from sela_tpu_torch.codec import corpus
    from sela_tpu_torch.ref.wav import WavData

    sound = corpus.encode_files

    def lossy(wavs, **kw):
        return sound([WavData(w.sample_rate, w.bits_per_sample,
                              [c & ~1 for c in w.channels]) for w in wavs],
                     **kw)

    return [(corpus, "encode_files", lossy)]
