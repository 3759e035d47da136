"""The port's corpus batch codec (codec/corpus.py) on the CPU, mirroring
tests/test_corpus.py: heterogeneous batches share device chunks, each stream
is the port's own per-file stream, and the JAX package and the oracle decode
it. (That both calls raise without CUDA when no device is named is in
tests/test_torch_isolation.py.)"""
import numpy as np
import pytest

from sela_tpu.codec import corpus as jax_corpus
from sela_tpu.ref import codec as jax_ref_codec
from sela_tpu_torch.codec import corpus
from sela_tpu_torch.codec.encoder import encode_wav
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
