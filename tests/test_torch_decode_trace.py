"""The port's decode (codec/decoder.py::decode_sela) with a Metrics sink:
it records its five stages, rice_unpack inside host_unpack and
device_dispatch apart from it, and its chunk counters; and not a sample
changes: with a sink, without one, the source PCM and the benchmark's
plain reference decoder (benchmark/reference/decode.py) agree."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sela_tpu_torch.codec import decoder
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.format import RICE_PARTITION_MARKER, SF_MID
from sela_tpu_torch.ref import container
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils.metrics import STAGE, Metrics

# the repo root, for the benchmark's reference, in every xdist worker
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from benchmark.reference.decode import decode as reference_decode  # noqa: E402

FS, CHUNK = 256, 3      # small frames; chunks of 3 frames, the last of 2
N = 7 * FS + 50         # 8 frames, a tail frame of 50 samples
STAGES = ("host_parse", "host_unpack", "device_dispatch", "device_fetch",
          "host_assemble")


def _tone(rng, n: int, amp: float, f: float, noise: float) -> np.ndarray:
    t = np.arange(n)
    return np.round(amp * np.sin(t * f) + rng.normal(0, noise, n)).astype(
        np.int32)


def _cases() -> dict:
    rng = np.random.default_rng(22)
    left = _tone(rng, N, 12000, 0.031, 40)
    return {
        # correlated channels: the est rule picks mid/side
        "v1_16_stereo": (WavData(44100, 16, [left, left + _tone(
            rng, N, 300, 0.05, 10)]), BitstreamProfile(frame_size=FS)),
        "v2_24_partitioned": (WavData(96000, 24, [
            _tone(rng, N, 3e6, 0.011, 4000), _tone(rng, N, 2e6, 0.017, 9000)]),
            BitstreamProfile(frame_size=FS, residue_partition=4)),
        "mono_16": (WavData(22050, 16, [_tone(rng, N, 9000, 0.07, 25)]),
                    BitstreamProfile(frame_size=FS)),
    }


CASES = _cases()
# chunks on the int32 wire: every 24-bit frame's warm-up samples leave int16
INT32_CHUNKS = {"v1_16_stereo": 0, "v2_24_partitioned": 3, "mono_16": 0}


def _scan(buf: bytes) -> dict:
    h = container.parse_header(buf)
    return decoder.scan(buf, container.HEADER_SIZE, h.num_frames,
                        h.channels)[0]


@pytest.fixture(scope="module")
def streams() -> dict:
    return {name: encode_wav(w, profile=p, device="cpu")
            for name, (w, p) in CASES.items()}


def _decode(buf: bytes, metrics=None) -> WavData:
    return decode_sela(buf, chunk_frames=CHUNK, device="cpu",
                       metrics=metrics)


def _same_pcm(a: WavData, b: WavData) -> None:
    assert (a.sample_rate, a.bits_per_sample, a.n_channels) == (
        b.sample_rate, b.bits_per_sample, b.n_channels)
    for x, y in zip(a.channels, b.channels):
        np.testing.assert_array_equal(x, y)


def test_cases_cover_their_layouts(streams):
    assert np.any(_scan(streams["v1_16_stereo"])["sftype"] == SF_MID)
    assert np.any(_scan(streams["v2_24_partitioned"])["k_res"]
                  == RICE_PARTITION_MARKER)
    assert container.parse_header(streams["mono_16"]).channels == 1


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_sink_changes_no_sample(name, streams):
    w, _ = CASES[name]
    buf = streams[name]
    traced = _decode(buf, Metrics())
    _same_pcm(traced, _decode(buf))
    _same_pcm(traced, w)
    rate, bits, chans = reference_decode(buf)
    _same_pcm(traced, WavData(rate, bits, chans))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stages_and_counters(name, streams):
    w, _ = CASES[name]
    m = Metrics()
    _decode(streams[name], m)
    n, c = m.stage_n, m.counters
    frames = -(-N // FS)
    chunks = -(-frames // CHUNK)
    assert set(m.stage_s) == set(STAGES) | {"rice_unpack"}
    assert c["frames"] == frames and c["chunks"] == chunks
    assert c["int32_wire_chunks"] == INT32_CHUNKS[name]
    assert c["coded_bytes"] == len(streams[name])
    assert c["pcm_bytes"] == N * w.n_channels * w.bits_per_sample // 8
    assert n["host_parse"] == 1
    assert (n["host_unpack"] == n["device_dispatch"] == n["device_fetch"]
            == chunks)
    assert n["rice_unpack"] == 2 * chunks   # coefficients, residues
    assert n["host_assemble"] == chunks + 1   # and the concatenation
    assert m.stage_s["rice_unpack"] <= m.stage_s["host_unpack"]


def test_stages_nest_as_documented(streams, monkeypatch):
    # a stand-in for the device step: the plain IIR's per-sample ops would
    # fill the trace, and only the stages' ranges are read here
    monkeypatch.setattr(decoder, "decode_step",
                        lambda res, *args, out_dtype: torch.zeros(
                            res.shape, dtype=out_dtype))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode(streams["v1_16_stereo"], Metrics())
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


def test_int32_wire_chunks_counts_the_loud_chunk():
    """A 24-bit stream, within int16 but for its second chunk's frames,
    which are full-scale noise: that chunk alone crosses on the int32
    wire."""
    rng = np.random.default_rng(5)
    chans = [_tone(rng, N, 20000, 0.02, 30) for _ in range(2)]
    loud = slice(CHUNK * FS, 2 * CHUNK * FS)
    for c in chans:
        c[loud] = rng.integers(-(1 << 23), 1 << 23, loud.stop - loud.start)
    w = WavData(48000, 24, chans)
    buf = encode_wav(w, frame_size=FS, device="cpu")
    sf = _scan(buf)
    fits = [decoder.unpack(sf, lo * 2, min(lo + CHUNK, 8) * 2, 2)[3]
            for lo in range(0, 8, CHUNK)]
    assert fits == [True, False, True]
    m = Metrics()
    _same_pcm(_decode(buf, m), w)
    assert m.counters["chunks"] == 3 and m.counters["int32_wire_chunks"] == 1
