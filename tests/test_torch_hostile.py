"""Mutation fuzz of the port's three decode paths on the CPU.

The port's container scan, Rice unpack, chunking and corpus grouping
(codec/decoder.py::scan and ::unpack, codec/stream.py, codec/corpus.py) are
written independently of sela_tpu's, so they get their own fuzz over the
mutation corpus of tests/test_property.py: a few bytes of a valid stream
XORed. Every mutated buffer goes through the port's decode_sela,
decode_stream and decode_files (device="cpu", one frame a chunk, so every
chunk border of a multi-frame clip is crossed), through their sela_tpu
counterparts (run as tests/test_property.py runs them) and through the
oracle, sela_tpu.ref.codec.decode_sela. The properties:

1. a port path raises nothing but the port's ContainerError (a plain
   ValueError only where its JAX counterpart raises one too);
2. each port path accepts exactly the buffers the oracle accepts;
3. where it accepts, its PCM equals its JAX counterpart's, value for value
   and dtype for dtype (int32 channels at every bit depth, and decode_sela's
   <=16-bit output narrowed to int16 as sela_tpu narrows it);
4. and equals the oracle's, but where a split that both packages share with
   it applies: decode_sela's narrowing (held instead to the oracle's samples
   wrapped to int16), and a reconstruction that leaves int32, whose history
   the oracle keeps unwrapped in int64 where both packages wrap every sample
   to 32 bits (K7's contract). Each split is pinned by a test below.

The examples are drawn from a fixed seed, so every run sees the same
buffers.
"""
import functools

import numpy as np
import pytest
from hypothesis import given, seed, settings, strategies as st

from sela_tpu.codec import corpus as jax_corpus
from sela_tpu.codec import decoder as jax_decoder
from sela_tpu.codec import stream as jax_stream
from sela_tpu.config import BitstreamProfile
from sela_tpu.errors import ContainerError as JaxContainerError
from sela_tpu.format import RICE_PARTITION_MARKER, SF_MID
from sela_tpu.ref import codec as ref_codec
from sela_tpu.ref import container as ref_container
from sela_tpu.ref import lpc as ref_lpc
from sela_tpu.ref import rice as ref_rice
from sela_tpu.ref.wav import WavData
from sela_tpu_torch.codec import corpus, decoder, stream
from sela_tpu_torch.errors import ContainerError

CHUNK = 1       # the port's chunks: a border between every two frames
JAX_CHUNK = 8   # tests/test_property.py's
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _mutate(data, buf: bytes, lo: int = 0, hi: int | None = None) -> bytes:
    out = bytearray(buf)
    hi = len(out) - 1 if hi is None else min(hi, len(out) - 1)
    n_flips = data.draw(st.integers(1, 8))
    for _ in range(n_flips):
        i = data.draw(st.integers(lo, hi))
        out[i] ^= data.draw(st.integers(1, 255))
    return bytes(out)


def _mono16() -> bytes:
    rng = np.random.default_rng(0)
    w = WavData(44100, 16, [rng.integers(-2000, 2000, 700).astype(np.int32)])
    return ref_codec.encode_wav(w)


def _stereo16() -> bytes:
    """The right channel follows the left, so mid/side subframes appear."""
    rng = np.random.default_rng(2)
    left = rng.integers(-2000, 2000, 700).astype(np.int32)
    right = (left // 2 + rng.integers(-100, 100, 700)).astype(np.int32)
    return ref_codec.encode_wav(WavData(44100, 16, [left, right]))


def _partitioned16() -> bytes:
    """A v2 (residue_partition=4) burst/quiet clip of two frames."""
    rng = np.random.default_rng(4)
    burst = rng.integers(-20000, 20000, 100).astype(np.int32)
    quiet = rng.integers(-40, 40, 600).astype(np.int32)
    w = WavData(44100, 16, [np.concatenate([burst, quiet, burst, quiet])])
    return ref_codec.encode_wav(
        w, profile=BitstreamProfile(residue_partition=4))


def _stereo24() -> bytes:
    """24-bit tones (LPC order 13: four coefficient words a subframe), the
    right channel following the left under noise."""
    rng = np.random.default_rng(5)
    t = np.arange(2000)
    tones = sum(a * np.sin(w * t + i) for i, (a, w) in enumerate(
        [(1, 0.031), (0.7, 0.077), (0.5, 0.19), (0.4, 0.43), (0.3, 0.9),
         (0.2, 1.6)]))
    left = np.round(1.5e6 * tones) + rng.integers(-40, 40, 2000)
    right = left * 0.6 + rng.integers(-300, 300, 2000)
    return ref_codec.encode_wav(WavData(96000, 24, [
        left.astype(np.int32), np.round(right).astype(np.int32)]))


def _mono32() -> bytes:
    """A 32-bit tone under noise holding INT32_MIN and INT32_MAX."""
    rng = np.random.default_rng(6)
    t = np.arange(700)
    x = (np.round(1.5e9 * np.sin(0.05 * t))
         + rng.integers(-1 << 20, 1 << 20, 700)).astype(np.int64)
    x[100], x[400] = INT32_MIN, INT32_MAX
    return ref_codec.encode_wav(WavData(48000, 32, [x.astype(np.int32)]))


CLIPS = {"mono16": _mono16, "stereo16": _stereo16,
         "partitioned16": _partitioned16, "stereo24": _stereo24,
         "mono32": _mono32}


@functools.lru_cache(maxsize=None)
def clip(name: str) -> bytes:
    return CLIPS[name]()


# --- the paths: each returns (sample_rate, bits, channels) or the exception

def _wav(w) -> tuple:
    return w.sample_rate, w.bits_per_sample, list(w.channels)


def _blocks(blocks: list, buf: bytes) -> tuple:
    """decode_stream's [n, C] blocks as channels; every block int32."""
    h = ref_container.parse_header(buf)
    for b in blocks:
        assert b.dtype == np.int32 and b.ndim == 2 and b.shape[1] == h.channels
    pcm = (np.concatenate(blocks) if blocks
           else np.zeros((0, h.channels), np.int32))
    return (h.sample_rate, h.bits_per_sample,
            [pcm[:, c] for c in range(h.channels)])


PORT = {
    "decode_sela": lambda b: _wav(decoder.decode_sela(b, CHUNK, device="cpu")),
    "decode_stream": lambda b: _blocks(
        list(stream.decode_stream(b, CHUNK, device="cpu")), b),
    "decode_files": lambda b: _wav(
        corpus.decode_files([b], CHUNK, device="cpu")[0]),
}
JAX = {
    "decode_sela": lambda b: _wav(jax_decoder.decode_sela(b, JAX_CHUNK)),
    "decode_stream": lambda b: _blocks(
        list(jax_stream.decode_stream(b, JAX_CHUNK)), b),
    "decode_files": lambda b: _wav(jax_corpus.decode_files([b], JAX_CHUNK)[0]),
}


def _run(fn, buf: bytes):
    """fn(buf), or the ValueError it raised (both packages' ContainerError is
    one); any other exception propagates and fails the test."""
    try:
        return fn(buf)
    except ValueError as e:
        return e


def _iir_int64(e: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The oracle's recurrence (ref/lpc.py::iir_synthesize) before its final
    cast: the unwrapped int64 samples."""
    hist = np.zeros(len(c), np.int64)
    x = np.empty(len(e), np.int64)
    half = 1 << (ref_lpc.REF_Q - 1)
    for i, ei in enumerate(e.astype(np.int64)):
        x[i] = ei + ((int(np.dot(c, hist)) + half) >> ref_lpc.REF_Q)
        hist[1:] = hist[:-1]
        hist[0] = x[i]
    return x


def _leaves_int32(buf: bytes) -> bool:
    """Whether the oracle's reconstruction of an accepted stream leaves int32:
    an IIR sample (the oracle carries it unwrapped in its int64 history; both
    packages wrap it), or the rounding step side + (side & 1) of a side
    sample (int64 in the oracle, int32 in both packages)."""
    h = ref_container.parse_header(buf)
    pos = ref_container.HEADER_SIZE
    for _ in range(h.num_frames):
        subframes, _, pos = ref_container.parse_frame(buf, pos, h.channels)
        mids = {sf.channel for sf in subframes if sf.sftype == SF_MID}
        for sf in subframes:
            if sf.k_res == RICE_PARTITION_MARKER:
                e = ref_rice.decode_partitioned(sf.res_words, sf.n_samples,
                                                sf.k_res_sub)
            else:
                e = ref_rice.decode(sf.res_words, sf.n_samples, sf.k_res)
            x = e.astype(np.int64)
            if sf.order:
                q = ref_rice.decode(sf.coeff_words, sf.order, sf.k_coeff)
                c = ref_lpc.reflection_to_lpc(ref_lpc.dequantize_reflection(q))
                x = _iir_int64(e, c.astype(np.int64))
                if len(x) and (x.min() < INT32_MIN or x.max() > INT32_MAX):
                    return True
            if sf.channel - 1 in mids and np.any(
                    x.astype(np.int32) == INT32_MAX):
                return True
    return False


def _equal(a: tuple, b: tuple) -> bool:
    return (a[:2] == b[:2] and len(a[2]) == len(b[2])
            and all(x.dtype == y.dtype and np.array_equal(x, y)
                    for x, y in zip(a[2], b[2])))


def _narrowed(want: tuple) -> tuple:
    """decode_sela's output for a <=16-bit stream: the samples wrapped to
    int16, returned as int32 (both packages)."""
    return want[0], want[1], [c.astype(np.int16).astype(np.int32)
                              for c in want[2]]


def check_buffer(buf: bytes) -> dict:
    """Run buf through the oracle and the three paths of both packages, and
    assert the four properties. Returns the paths that accepted it."""
    try:
        want = _wav(ref_codec.decode_sela(buf))
    except JaxContainerError:
        want = None
    leaves = want is not None and _leaves_int32(buf)
    accepted = {}
    for name, port_fn in PORT.items():
        got = _run(port_fn, buf)
        ref = _run(JAX[name], buf)
        if isinstance(got, Exception):
            # 1: the port's own ContainerError, or a ValueError where JAX
            # raises a plain one too
            if not isinstance(got, ContainerError):
                assert isinstance(ref, ValueError) and not isinstance(
                    ref, JaxContainerError), (name, got, ref)
            assert want is None, (name, "refused what the oracle accepts", got)
            continue
        assert want is not None, (name, "accepted what the oracle rejects")
        assert not isinstance(ref, Exception), (name, "JAX rejected", ref)
        assert _equal(got, ref), (name, "PCM differs from sela_tpu's")   # 3
        if not leaves:                                                    # 4
            oracle = (_narrowed(want) if name == "decode_sela"
                      and want[1] <= 16 else want)
            assert _equal(got, oracle), (name, "PCM differs from the oracle's")
        accepted[name] = got
    return accepted


# --- the fuzz: each clip, and the header regions of two clips -------------

@pytest.mark.parametrize("name", list(CLIPS))
@seed(20261017)
@settings(deadline=None, max_examples=8, database=None)
@given(data=st.data())
def test_port_decode_paths_under_mutation(name, data):
    check_buffer(_mutate(data, clip(name)))


@pytest.mark.parametrize("name,hi", [("mono16", 40), ("stereo24", 47)])
@seed(20261017)
@settings(deadline=None, max_examples=50, database=None)
@given(data=st.data())
def test_port_decode_paths_under_header_region_mutation(name, hi, data):
    """The file header and the first frame and subframe headers: the mono
    clip's only channel, type, order and k bytes; the 24-bit clip's first
    subframe with its coefficient words."""
    check_buffer(_mutate(data, clip(name), lo=0, hi=hi))


@pytest.mark.parametrize("name", list(CLIPS))
def test_base_clips_decode_on_every_path(name):
    """The unmutated clips: every path accepts and gives the oracle's PCM."""
    accepted = check_buffer(clip(name))
    assert set(accepted) == set(PORT)


# --- the splits shared with sela_tpu, each pinned ------------------------

def _flipped(buf: bytes, flips) -> bytes:
    out = bytearray(buf)
    for i, x in flips:
        out[i] ^= x
    return bytes(out)


def test_split_decode_sela_narrows_16bit_output_as_sela_tpu():
    """The mono clip with byte 27 ^= 5: the first subframe becomes order 0
    with k_res 15, and its samples leave int16. decode_sela narrows them in
    both packages; decode_stream and decode_files keep the oracle's."""
    buf = _flipped(clip("mono16"), [(27, 5)])
    want = _wav(ref_codec.decode_sela(buf))
    assert (want[2][0].min(), want[2][0].max()) == (-95390, 97155)
    accepted = check_buffer(buf)
    sela = accepted["decode_sela"][2][0]
    assert np.count_nonzero(sela != want[2][0]) == 131
    np.testing.assert_array_equal(sela, want[2][0].astype(np.int16))
    for name in ("decode_stream", "decode_files"):
        np.testing.assert_array_equal(accepted[name][2][0], want[2][0])


MONO32_WRAP = [(144, 106)]   # (byte, xor), found by the fuzz's seed


def test_split_32bit_reconstruction_wraps_as_sela_tpu():
    """A mutated 32-bit stream whose reconstruction leaves int32: the oracle
    carries the unwrapped samples in its history, both packages wrap them,
    so all six paths agree with each other and not with the oracle."""
    buf = _flipped(clip("mono32"), MONO32_WRAP)
    assert _leaves_int32(buf)
    want = _wav(ref_codec.decode_sela(buf))
    accepted = check_buffer(buf)
    assert set(accepted) == set(PORT)
    for got in accepted.values():
        assert got[2][0].dtype == np.int32
        assert not np.array_equal(got[2][0], want[2][0])
