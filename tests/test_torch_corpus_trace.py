"""The port's corpus batch encode (codec/corpus.py::encode_files) with a
Metrics sink: it runs encode_wav's chunk engine, so it records encode_wav's
stages, with the same nesting, and counters, and the batch's own; and not a
byte changes. metrics=None reads no clock."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sela_tpu_torch.codec import corpus
from sela_tpu_torch.codec.encoder import encode_wav, frame_batches
from sela_tpu_torch.codec.pipeline import encode_step
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils import metrics as metrics_mod
from sela_tpu_torch.utils.metrics import NULL_METRICS, STAGE, Metrics

FS, CHUNK = 64, 4   # small frames and chunks: several chunks a group
TOP = ("host_frame", "device_dispatch", "device_fetch", "host_pack",
       "host_assemble")
INNER = ("pack_gather", "rice_count", "rice_pack", "emit")


def _quiet(rng, n: int, f: float) -> np.ndarray:
    t = np.arange(n)
    return np.round(3000 * np.sin(t * f) + rng.normal(0, 20, n)).astype(
        np.int32)


def _batch() -> list[WavData]:
    """Mono and stereo, 16- and 24-bit, one file shorter than a frame. The
    mono group is all 16-bit, so it crosses to the device as int16; its
    short file is a full-scale square wave whose residues leave int16. The
    stereo group's loud 24-bit noise puts it on the int32 wire; its quiet
    16-bit files fill the chunks before and after it."""
    rng = np.random.default_rng(18)
    loud = (1 << 23) - 1
    square = np.where(np.arange(FS - 9) % 20 < 10, 32767, -32768)
    return [
        WavData(22050, 16, [_quiet(rng, 5 * FS + 7, 0.05)]),
        WavData(44100, 16, [_quiet(rng, CHUNK * FS, 0.03),
                            _quiet(rng, CHUNK * FS, 0.07)]),
        WavData(48000, 24, [rng.integers(-loud, loud, 3 * FS + 5,
                                         dtype=np.int32) for _ in range(2)]),
        WavData(48000, 16, [square.astype(np.int32)]),
        WavData(44100, 16, [_quiet(rng, 2 * FS, 0.04),
                            _quiet(rng, 2 * FS, 0.05)]),
    ]


GROUPS = ([0, 3], [1, 2, 4])   # mono, stereo: each file's group, in order


def _frames(w: WavData) -> int:
    return -(-w.n_samples // FS)


def _encode(wavs, metrics):
    return corpus.encode_files(wavs, chunk_frames=CHUNK, frame_size=FS,
                               device="cpu", metrics=metrics)


@pytest.fixture(scope="module")
def traced():
    wavs = _batch()
    m = Metrics()
    return wavs, _encode(wavs, m), m


def test_a_sink_changes_no_byte(traced):
    wavs, bufs, _ = traced
    assert _encode(wavs, None) == bufs
    assert _encode(wavs, NULL_METRICS) == bufs
    assert corpus.encode_files(wavs, chunk_frames=CHUNK, frame_size=FS,
                               device="cpu") == bufs
    for w, buf in zip(wavs, bufs):
        assert buf == encode_wav(w, frame_size=FS, chunk_frames=CHUNK,
                                 device="cpu")


def test_counters_are_the_batchs(traced):
    """encode_wav's counters over the batch's chunks, and the batch's."""
    wavs, bufs, m = traced
    c = m.counters
    group_frames = [sum(_frames(wavs[i]) for i in g) for g in GROUPS]
    chunks = sum(-(-f // CHUNK) for f in group_frames)
    assert c["files"] == 5 and c["groups"] == 2
    assert c["chunks"] == c["step_eager"] == chunks   # eager on the CPU
    assert c["frames"] == sum(group_frames)
    # the CPU packs every block on the host
    assert c["pack_blocks_host"] == 2 * sum(_frames(w) * w.n_channels
                                            for w in wavs)
    assert "pack_blocks_device" not in c
    assert c["pcm_bytes"] == sum(w.n_samples * w.n_channels
                                 * w.bits_per_sample // 8 for w in wavs)
    assert c["coded_bytes"] == sum(len(b) for b in bufs)
    # of the mono group's two chunks the second alone holds the square
    # wave; the stereo group, on the int32 wire, has nothing to fetch
    assert group_frames[0] == 2 * CHUNK - 1 and c["int32_fetch"] == 1


def test_int32_fetch_counts_the_chunks_that_leave_int16(traced):
    """As encode_wav counts it: a chunk on the int16 wire whose residues do
    not all fit int16; none on the int32 wire."""
    wavs, _, m = traced
    leave = 0
    for idxs in GROUPS:
        if any(wavs[i].bits_per_sample > 16 for i in idxs):
            continue   # the int32 wire
        framed = [frame_batches(wavs[i].channels, FS) for i in idxs]
        x = np.concatenate([f[0] for f in framed])
        nv = np.concatenate([f[1] for f in framed])
        for s in range(0, len(x), CHUNK):
            out = encode_step(torch.from_numpy(x[s:s + CHUNK]),
                              torch.from_numpy(nv[s:s + CHUNK]))
            leave += not bool(out["fits16"].all())
    assert leave > 0 and m.counters["int32_fetch"] == leave


def test_stage_counts_and_seconds(traced):
    """host_pack once a chunk, emit once for each file's frames in a
    chunk, the framing once a chunk, straight into its slot, and the
    assembly once a file."""
    wavs, _, m = traced
    n, c = m.stage_n, m.counters
    pieces = 0
    for idxs in GROUPS:
        bounds = np.cumsum([0] + [_frames(wavs[i]) for i in idxs])
        pieces += sum((hi - 1) // CHUNK - lo // CHUNK + 1
                      for lo, hi in zip(bounds[:-1], bounds[1:]))
    assert (n["host_frame"] == n["device_dispatch"] == n["device_fetch"]
            == n["host_pack"] == c["chunks"])
    # one gather before each block kind's native calls
    assert n["pack_gather"] == n["rice_count"] == n["rice_pack"] == (
        2 * c["chunks"])
    assert n["emit"] == pieces > c["chunks"]
    assert n["host_assemble"] == c["files"] == len(wavs)
    s = m.stage_s
    assert sum(s[k] for k in INNER) <= s["host_pack"]


def test_stages_nest_as_encode_wavs():
    wavs = _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _encode(wavs, Metrics())
    ranges: dict[str, list] = {}
    for e in prof.events():
        if e.name.startswith(STAGE):
            ranges.setdefault(e.name[len(STAGE):], []).append(
                (e.time_range.start, e.time_range.end))
    assert set(ranges) == set(TOP) | set(INNER), sorted(ranges)

    def inside(name, outer):
        return all(any(a0 <= a and b <= b0 for a0, b0 in ranges[outer])
                   for a, b in ranges[name])

    for name in INNER:
        assert inside(name, "host_pack"), name
    for name in TOP:   # the five outer stages never nest in one another
        for other in set(TOP) - {name}:
            assert not any(a0 <= a and b <= b0 for a, b in ranges[name]
                           for a0, b0 in ranges[other]), (name, other)


def test_no_sink_reads_no_clock(monkeypatch, traced):
    wavs, bufs, _ = traced

    def no_clock():
        raise AssertionError("a clock was read")

    monkeypatch.setattr(metrics_mod, "time", types.SimpleNamespace(
        perf_counter=no_clock, time=no_clock))
    assert _encode(wavs, None) == bufs
    assert NULL_METRICS.counters == {} and NULL_METRICS.stage_s == {}
    with pytest.raises(AssertionError, match="a clock was read"):
        _encode(wavs, Metrics())
