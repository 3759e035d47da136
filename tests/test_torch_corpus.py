"""The port's corpus batch codec (codec/corpus.py) on the CPU, mirroring
tests/test_corpus.py: heterogeneous batches share device chunks, each stream
is the port's own per-file stream, and the JAX package and the oracle decode
it. (That both calls raise without CUDA when no device is named is in
tests/test_torch_isolation.py.)"""
import numpy as np
import pytest

import chip_smoke as cs
from sela_tpu.codec import corpus as jax_corpus
from sela_tpu.ref import codec as jax_ref_codec
from sela_tpu_torch.codec import corpus
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.errors import ContainerError
from sela_tpu_torch.ref import container
from sela_tpu_torch.ref import rice as ref_rice
from sela_tpu_torch.ref.wav import WavData

CHUNK = 8


def _mixed_corpus(rng, signal_factory, n_files=8):
    """Mono, stereo and 3-channel files at 16 and 24 bits; the 16- and 24-bit
    stereo files share a group."""
    wavs = []
    for i in range(n_files):
        nch = [1, 2, 2, 3][i % 4]
        bps = [16, 16, 24, 16][i % 4]
        n = int(rng.integers(500, 5000))
        kinds = ["ar", "tone", "noise"]
        chans = [
            signal_factory(rng, n, amp=2 ** (min(bps, 16) - 1) - 2,
                           kind=kinds[c % 3])
            for c in range(nch)
        ]
        rate = [44100, 48000, 96000][i % 3]
        wavs.append(WavData(rate, bps, chans))
    return wavs


def test_encode_files_round_trip(rng, signal_factory):
    wavs = _mixed_corpus(rng, signal_factory)
    bufs = corpus.encode_files(wavs, chunk_frames=CHUNK, device="cpu")
    outs = corpus.decode_files(bufs, chunk_frames=CHUNK, device="cpu")
    for w, o in zip(wavs, outs):
        assert (o.sample_rate, o.bits_per_sample) == (w.sample_rate,
                                                      w.bits_per_sample)
        for a, b in zip(o.channels, w.channels):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def test_batch_byte_equals_per_file_encode(rng, signal_factory):
    """Grouping files into shared chunks does not change a byte of any
    file's stream."""
    wavs = _mixed_corpus(rng, signal_factory, n_files=6)
    bufs = corpus.encode_files(wavs, chunk_frames=CHUNK, device="cpu")
    for w, buf in zip(wavs, bufs):
        assert buf == encode_wav(w, chunk_frames=CHUNK, device="cpu")


def test_batch_streams_decode_through_jax_and_oracle(rng, signal_factory):
    wavs = _mixed_corpus(rng, signal_factory, n_files=4)
    bufs = corpus.encode_files(wavs, chunk_frames=CHUNK, device="cpu")
    outs = jax_corpus.decode_files(bufs, chunk_frames=CHUNK)
    for w, buf, o in zip(wavs, bufs, outs):
        for got in (o, jax_ref_codec.decode_sela(buf)):
            for a, b in zip(got.channels, w.channels):
                np.testing.assert_array_equal(a, b)
    # and the JAX batch's streams through the port's decode_files
    jax_bufs = jax_corpus.encode_files(wavs, chunk_frames=CHUNK)
    for w, o in zip(wavs, corpus.decode_files(jax_bufs, device="cpu")):
        for a, b in zip(o.channels, w.channels):
            np.testing.assert_array_equal(a, b)


def test_decode_files_keeps_16bit_samples_that_leave_int16():
    """decode_files returns int32 at every bit depth, as sela_tpu's does:
    tests/test_property.py's mono clip with byte 27 ^= 5 (its first subframe
    becomes order 0 with k_res 15) decodes to the oracle's samples,
    -95,390..97,155, none wrapped to int16."""
    rng = np.random.default_rng(0)
    w = WavData(44100, 16, [rng.integers(-2000, 2000, 700).astype(np.int32)])
    buf = bytearray(jax_ref_codec.encode_wav(w))
    buf[27] ^= 5
    buf = bytes(buf)
    want = jax_ref_codec.decode_sela(buf).channels[0]
    assert (want.min(), want.max()) == (-95390, 97155)
    got = corpus.decode_files([buf], chunk_frames=CHUNK, device="cpu")[0]
    ref = jax_corpus.decode_files([buf], chunk_frames=CHUNK)[0]
    assert got.channels[0].dtype == ref.channels[0].dtype == np.int32
    np.testing.assert_array_equal(got.channels[0], ref.channels[0])
    np.testing.assert_array_equal(got.channels[0], want)


def _damaged(buf: bytes) -> list[bytes]:
    """A flipped frame sync, a truncation mid-frame, trailing junk, and an
    out-of-range quantized coefficient (q = 127 in the first coefficient
    block: a valid Rice block that the decoder must reject)."""
    h = container.parse_header(buf)
    sync = bytearray(buf)
    sync[container.HEADER_SIZE] ^= 0xFF
    subframes, ns, end = container.parse_frame(buf, container.HEADER_SIZE,
                                                h.channels)
    sf = subframes[0]
    sf.order = max(sf.order, 1)
    _, sf.coeff_words = ref_rice.encode(np.full(sf.order, 127, np.int32),
                                        sf.k_coeff)
    bad_q = (buf[: container.HEADER_SIZE]
             + container.serialize_frame(subframes, ns) + buf[end:])
    return [bytes(sync), buf[: end - 3], buf + b"junk", bad_q]


def test_damaged_buffer_raises_container_error(rng, signal_factory):
    wavs = _mixed_corpus(rng, signal_factory, n_files=2)
    bufs = corpus.encode_files(wavs, chunk_frames=CHUNK, device="cpu")
    for bad in _damaged(bufs[1]):
        with pytest.raises(ContainerError):
            corpus.decode_files([bufs[0], bad], device="cpu")


# ------------------------------------------------ encode_files' frame_size --
# chip_smoke.py's encode sweep (tests/test_torch_encode_sweep.py): its
# 24-bit default-profile cases at frame sizes 1,000 and 33
SWEEP = cs.sweep_cases()


def _sweep_wav(case: dict) -> WavData:
    return WavData(case["rate"], case["bits"], case["chans"])


@pytest.mark.parametrize("frame_size", [1000, 33])
def test_encode_files_frame_size_matches_jax(frame_size):
    """24-bit stereo at 1,000 and six channels at 33: each stream is the
    port's encode_wav at that frame size, decodes through the oracle and is
    <= 1.005x the JAX encode_files' (whose signature is these cases' JAX
    encode_wav's in tests/test_torch_encode_sweep.py)."""
    cases = [c for c in SWEEP if not c["profile"] and c["bits"] == 24
             and c["frame_size"] == frame_size]
    wavs = [_sweep_wav(c) for c in cases]
    bufs = corpus.encode_files(wavs, chunk_frames=3, frame_size=frame_size,
                               device="cpu")
    jax_bufs = jax_corpus.encode_files(wavs, chunk_frames=CHUNK,
                                       frame_size=frame_size)
    assert len(bufs) == len(jax_bufs) > 3
    for w, buf, jax_buf in zip(wavs, bufs, jax_bufs):
        assert buf == encode_wav(w, frame_size=frame_size, device="cpu")
        out = jax_ref_codec.decode_sela(buf)
        assert (out.sample_rate, out.bits_per_sample) == (w.sample_rate,
                                                          w.bits_per_sample)
        for a, b in zip(out.channels, w.channels, strict=True):
            np.testing.assert_array_equal(a, b)
        assert len(buf) <= 1.005 * len(jax_buf), (len(buf), len(jax_buf))


@pytest.mark.parametrize("frame_size", [0, -5, 16, 31, 100.0])
def test_encode_files_refuses_what_sela_tpu_refuses(frame_size):
    w = _sweep_wav(SWEEP[0])
    with pytest.raises(Exception):
        jax_corpus.encode_files([w], chunk_frames=CHUNK,
                                frame_size=frame_size)
    with pytest.raises(TypeError if isinstance(frame_size, float)
                       else ValueError):
        corpus.encode_files([w], frame_size=frame_size, device="cpu")


@pytest.mark.parametrize("frame_size", [2049, 4096])
def test_frame_sizes_over_the_container_cap_are_refused(frame_size):
    """sela_tpu's encode_files writes frames over 2,048 samples, which
    every decoder refuses; the port's encode_files and encode_wav refuse
    the frame size, with the profile's message."""
    w = _sweep_wav(SWEEP[0])
    with pytest.raises(ValueError) as want:
        BitstreamProfile(frame_size=frame_size).validate()
    for encode in (
            lambda: corpus.encode_files([w], frame_size=frame_size,
                                        device="cpu"),
            lambda: encode_wav(w, frame_size=frame_size, device="cpu")):
        with pytest.raises(ValueError) as got:
            encode()
        assert str(got.value) == str(want.value)
