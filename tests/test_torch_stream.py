"""The port's streaming decode and packet queue (codec/stream.py) on the CPU,
mirroring tests/test_stream.py, against the port's decode_sela and the JAX
package's decode_stream."""
import threading
import time

import numpy as np
import pytest

from sela_tpu.codec.stream import decode_stream as jax_decode_stream
from sela_tpu.ref import codec as jax_ref_codec
from sela_tpu.ref.wav import WavData as JaxWavData
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.codec.stream import (PacketQueue, StreamingPlayer,
                                         decode_stream)
from sela_tpu_torch.errors import ContainerError
from sela_tpu_torch.ref import container
from sela_tpu_torch.ref.wav import WavData


def make_wav(rng, signal_factory, n=2048 * 3 + 300, bits=16):
    return WavData(
        44100, bits,
        [signal_factory(rng, n, kind="ar"), signal_factory(rng, n, kind="tone")],
    )


@pytest.mark.parametrize("bits", [16, 24])
def test_decode_stream_matches_full_decode_and_jax(rng, signal_factory, bits):
    w = make_wav(rng, signal_factory, bits=bits)
    buf = encode_wav(w, chunk_frames=8, device="cpu")
    blocks = list(decode_stream(buf, chunk_frames=3, device="cpu"))
    assert len(blocks) == 4  # one block a frame
    want = list(jax_decode_stream(buf, chunk_frames=2))
    for got, ref in zip(blocks, want):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    pcm = np.concatenate(blocks, axis=0)
    assert pcm.shape == (w.n_samples, 2)
    full = decode_sela(buf, device="cpu")
    for c in range(2):
        np.testing.assert_array_equal(pcm[:, c], full.channels[c])
        np.testing.assert_array_equal(pcm[:, c], w.channels[c])


def _wrapping_stream() -> bytes:
    """tests/test_property.py's mono clip with byte 27 ^= 5: a structurally
    valid stream whose first subframe becomes order 0 with k_res 15, so its
    samples leave int16 (-95,390..97,155)."""
    rng = np.random.default_rng(0)
    w = JaxWavData(44100, 16, [rng.integers(-2000, 2000, 700).astype(np.int32)])
    buf = bytearray(jax_ref_codec.encode_wav(w))
    buf[27] ^= 5
    return bytes(buf)


def test_decode_stream_keeps_16bit_samples_that_leave_int16():
    """decode_stream returns int32 at every bit depth, as sela_tpu's does:
    on this stream the oracle's samples, none wrapped to int16."""
    buf = _wrapping_stream()
    want = jax_ref_codec.decode_sela(buf).channels[0]
    assert (want.min(), want.max()) == (-95390, 97155)
    got = np.concatenate(list(decode_stream(buf, chunk_frames=3, device="cpu")))
    ref = np.concatenate(list(jax_decode_stream(buf, chunk_frames=8)))
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:, 0], want)


def test_decode_stream_raises_midstream_on_corruption(rng, signal_factory):
    w = make_wav(rng, signal_factory)
    buf = bytearray(encode_wav(w, chunk_frames=8, device="cpu"))
    # corrupt the LAST frame's sync word: earlier frames must still stream
    pos = container.HEADER_SIZE
    for _ in range(3):
        _, _, pos = container.parse_frame(bytes(buf), pos, 2)
    buf[pos] ^= 0xFF
    got = []
    with pytest.raises(ContainerError):
        for block in decode_stream(bytes(buf), chunk_frames=1, device="cpu"):
            got.append(block)
    assert len(got) == 3
    for c in range(2):
        np.testing.assert_array_equal(
            np.concatenate([b[:, c] for b in got]), w.channels[c][: 3 * 2048])


@pytest.mark.parametrize("fmt", ["setg", "apev2"])
def test_decode_stream_accepts_tags_trailer(rng, signal_factory, fmt):
    w = make_wav(rng, signal_factory, n=2048 + 5)
    buf = container.replace_tags(encode_wav(w, device="cpu"),
                                 {"title": "t", "artist": "a"}, fmt=fmt)
    pcm = np.concatenate(list(decode_stream(buf, device="cpu")))
    for c in range(2):
        np.testing.assert_array_equal(pcm[:, c], w.channels[c])
    with pytest.raises(ContainerError):   # junk after the trailer
        list(decode_stream(buf + b"\x00", device="cpu"))


def test_packet_queue_bounded_and_ordered():
    q = PacketQueue(max_blocks=2)
    got = []

    def consumer():
        while True:
            b = q.get()
            if b is None:
                return
            got.append(b)
            time.sleep(0.001)

    t = threading.Thread(target=consumer)
    t.start()
    blocks = [np.full((4, 2), i, np.int32) for i in range(16)]
    for b in blocks:
        assert q.put(b)
        assert len(q) <= 2  # bounded
    q.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert [int(b[0, 0]) for b in got] == list(range(16))


def test_packet_queue_abort_unblocks_producer():
    q = PacketQueue(max_blocks=1)
    q.put(np.zeros((1, 1), np.int32))
    done = []

    def producer():
        done.append(q.put(np.ones((1, 1), np.int32)))  # blocks until abort

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    q.abort()
    t.join(timeout=5)
    assert not t.is_alive()
    assert done == [False]
    assert q.get() is None


def test_streaming_player_end_to_end(rng, signal_factory):
    w = make_wav(rng, signal_factory, n=2048 * 2 + 10)
    buf = encode_wav(w, chunk_frames=8, device="cpu")
    player = StreamingPlayer(buf, chunk_frames=1, max_blocks=2, device="cpu")
    pcm = np.concatenate(list(player), axis=0)
    for c in range(2):
        np.testing.assert_array_equal(pcm[:, c], w.channels[c])


def test_streaming_player_surfaces_errors(rng, signal_factory):
    w = make_wav(rng, signal_factory, n=2048 * 2)
    buf = encode_wav(w, chunk_frames=8, device="cpu")
    player = StreamingPlayer(buf[:-3], chunk_frames=1, device="cpu")
    got = []
    with pytest.raises(ContainerError):
        for block in player:
            got.append(block)
    assert len(got) == 1   # the frame before the damage
