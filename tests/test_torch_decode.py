"""Port decode on the CPU against the JAX package, the oracle and the input.

- `codec.pipeline.decode_step(device="cpu")` against the JAX
  `decode_step(iir="scan")` on identical plan arrays (C = 1..4, int16 and
  int32 wires, mid/side present);
- `codec.decoder.decode_sela(device="cpu")` against the input PCM and the
  JAX `decode_sela`, on streams written by the JAX encoder and the oracle;
- every malformed stream of tests/test_hostile.py raises the port's own
  ContainerError.
All comparisons are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.codec import decoder as jax_decoder
from sela_tpu.codec import encoder as jax_encoder
from sela_tpu.codec.pipeline import decode_step as jax_decode_step
from sela_tpu.config import BitstreamProfile
from sela_tpu.format import MAX_ORDER, SF_DIRECT, SF_MID, SF_SIDE
from sela_tpu.ref import codec as ref_codec
from sela_tpu.ref import container, rice
from sela_tpu.ref.wav import WavData
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.pipeline import decode_step
from sela_tpu_torch.errors import ContainerError

CHUNK = 8   # the JAX decoder's chunk, as in the other JAX tests


# ------------------------------------------------------------ decode_step --

def _plan(rng, F: int, C: int, S: int, wire):
    lim = (1 << 15) if wire == np.int16 else (1 << 24)
    residues = rng.integers(-lim, lim, (F, C, S)).astype(wire)
    order = rng.integers(0, MAX_ORDER + 1, (F, C)).astype(np.int32)
    q = rng.integers(-64, 64, (F, C, MAX_ORDER)).astype(np.int32)
    q[np.arange(MAX_ORDER)[None, None, :] >= order[..., None]] = 0
    sftype = np.full((F, C), SF_DIRECT, np.int32)
    for p in range(C // 2):
        ms = rng.random(F) < 0.6
        ms[0] = True                      # mid/side present in every case
        sftype[ms, 2 * p] = SF_MID
        sftype[ms, 2 * p + 1] = SF_SIDE
    return residues, q, order, sftype


@pytest.mark.parametrize("wire", [np.int16, np.int32])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_decode_step_matches_jax(C, wire):
    rng = np.random.default_rng(C * 10 + (wire == np.int32))
    plan = _plan(rng, 3, C, 512, wire)
    out16 = wire == np.int16
    want = np.asarray(jax_decode_step(
        *[jnp.asarray(a) for a in plan], iir="scan",
        out_dtype="int16" if out16 else "int32"))
    got = decode_step(*[torch.from_numpy(a) for a in plan],
                      out_dtype=torch.int16 if out16 else torch.int32)
    assert got.dtype == (torch.int16 if out16 else torch.int32)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ decode_sela --

def _music(rng, n: int, C: int, bits: int) -> list[np.ndarray]:
    t = np.arange(n)
    base = np.sin(2 * np.pi * 330 * t / 44100) + 0.4 * np.sin(
        2 * np.pi * 831 * t / 44100)
    amp = 0.6 * ((1 << (bits - 1)) - 1)
    chans = []
    for c in range(C):
        x = amp * (0.9 - 0.1 * c) * base + rng.normal(0, amp / 300 + 1, n)
        chans.append(np.clip(np.round(x), -(1 << (bits - 1)),
                             (1 << (bits - 1)) - 1).astype(np.int32))
    return chans


def _percussive(rng, n: int) -> list[np.ndarray]:
    env = np.zeros(n)
    period = int(0.12 * 44100)
    for s in range(0, n, period):
        L = min(period, n - s)
        env[s : s + L] = np.exp(-np.arange(L) / (0.015 * 44100))
    t = np.arange(n) / 44100
    sig = env * np.sin(2 * np.pi * 180 * t) * 24000 + rng.normal(0, 120, n) * (
        0.15 + env)
    left = np.clip(np.round(sig), -32767, 32767).astype(np.int32)
    right = np.clip(np.round(np.roll(sig, 31) * 0.94), -32767, 32767)
    return [left, right.astype(np.int32)]


def _stream(case: str):
    """(wav, .sela bytes) for one named case."""
    rng = np.random.default_rng(CASES.index(case))
    tail = 2048 * 2 + 123
    if case == "jax_16bit_stereo":
        w = WavData(44100, 16, _music(rng, tail, 2, 16))
        return w, jax_encoder.encode_wav(w, chunk_frames=CHUNK)
    if case == "jax_24bit_stereo":
        w = WavData(96000, 24, _music(rng, tail, 2, 24))
        return w, jax_encoder.encode_wav(w, chunk_frames=CHUNK)
    if case == "oracle_8bit_mono":
        w = WavData(8000, 8, _music(rng, 200, 1, 8))
        return w, ref_codec.encode_wav(w)
    if case == "oracle_32bit_extremes":
        chans = _music(rng, 2048 + 300, 2, 32)
        chans[0][100], chans[0][2100] = -(1 << 31), (1 << 31) - 1
        chans[1][7] = -(1 << 31)
        w = WavData(48000, 32, chans)
        return w, ref_codec.encode_wav(w)
    if case == "oracle_4ch":
        w = WavData(44100, 16, _music(rng, tail, 4, 16))
        return w, ref_codec.encode_wav(w)
    if case == "oracle_partition4":
        w = WavData(44100, 16, _percussive(rng, 3 * 2048 + 5))
        buf = ref_codec.encode_wav(w, profile=BitstreamProfile(residue_partition=4))
        return w, buf
    if case == "oracle_setg_tags":
        w = WavData(44100, 16, _music(rng, tail, 2, 16))
        return w, ref_codec.encode_wav(w, tags={"title": "Étude", "n": "1"})
    if case == "oracle_apev2_tags":
        w = WavData(44100, 16, _music(rng, tail, 2, 16))
        tags = {"Title": "Sine", "Cover Art (Front)": b"\x89PNG\x00\xff"}
        return w, container.replace_tags(ref_codec.encode_wav(w), tags,
                                          fmt="apev2")
    raise ValueError(case)


CASES = ["jax_16bit_stereo", "jax_24bit_stereo", "oracle_8bit_mono",
         "oracle_32bit_extremes", "oracle_4ch", "oracle_partition4",
         "oracle_setg_tags", "oracle_apev2_tags"]


@pytest.mark.parametrize("case", CASES)
def test_decode_sela_matches_input_and_jax(case):
    w, buf = _stream(case)
    if case == "oracle_partition4":
        h = container.parse_header(buf)
        pos, marked = container.HEADER_SIZE, 0
        for _ in range(h.num_frames):
            sfs, _, pos = container.parse_frame(buf, pos, h.channels)
            marked += sum(sf.k_res_sub is not None for sf in sfs)
        assert marked > 0, "the stream holds no partitioned subframe"
    want = jax_decoder.decode_sela(buf, chunk_frames=CHUNK)
    for chunk in (2, 512):                 # smaller than F, and all of it
        got = decode_sela(buf, chunk_frames=chunk, device="cpu")
        assert (got.sample_rate, got.bits_per_sample) == (
            w.sample_rate, w.bits_per_sample)
        for a, b, c in zip(got.channels, w.channels, want.channels):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_decode_sela_rejects_bad_chunk():
    _, buf = _stream("oracle_8bit_mono")
    with pytest.raises(ValueError):
        decode_sela(buf, chunk_frames=0, device="cpu")


# ---------------------------------------------------------------- hostile --

def _reserialize(buf: bytes, mutate) -> bytes:
    h = container.parse_header(buf)
    pos = container.HEADER_SIZE
    frames = []
    for f in range(h.num_frames):
        subframes, ns, pos = container.parse_frame(buf, pos, h.channels)
        subframes = mutate(f, subframes) or subframes
        frames.append(container.serialize_frame(subframes, ns))
    return container.serialize_file(h, frames)


@pytest.fixture(scope="module")
def stereo():
    rng = np.random.default_rng(7)
    n = 900
    left = rng.integers(-3000, 3000, n).astype(np.int32)
    right = (left * 0.8 + rng.integers(-200, 200, n)).astype(np.int32)
    w = WavData(44100, 16, [left, right])
    return w, ref_codec.encode_wav(w)


def _set(i, **fields):
    def mutate(f, sfs):
        for k, v in fields.items():
            setattr(sfs[i], k, v)
        return sfs
    return mutate


def _coeff_value(i, value):
    def mutate(f, sfs):
        k_c, cw = rice.encode(np.array([value], np.int32))
        sfs[i].order, sfs[i].k_coeff, sfs[i].coeff_words = 1, k_c, cw
        return sfs
    return mutate


def _both(t0, t1):
    def mutate(f, sfs):
        sfs[0].sftype, sfs[1].sftype = t0, t1
        return sfs
    return mutate


def _dup_channel(f, sfs):
    sfs[1].channel = sfs[0].channel
    return sfs


MUTATIONS = {
    "channel_out_of_range": _set(0, channel=255),
    "duplicate_channel": _dup_channel,
    "mid_without_side": _both(SF_MID, SF_DIRECT),
    "orphan_side": _both(SF_SIDE, SF_DIRECT),
    "bad_subframe_type": _set(0, sftype=7),
    "rice_k_res_out_of_range": _set(0, k_res=200),
    "rice_k_coeff_out_of_range": _set(1, k_coeff=32),
    "coeff_value_too_high": _coeff_value(0, 100),
    "coeff_value_too_low": _coeff_value(1, -65),
    "order_out_of_range": _set(0, order=200, coeff_words=np.zeros(0, np.uint32)),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_hostile_stream_raises_port_error(stereo, name):
    bad = _reserialize(stereo[1], MUTATIONS[name])
    with pytest.raises(ContainerError):
        decode_sela(bad, chunk_frames=8, device="cpu")


@pytest.mark.parametrize("cut", ["truncated", "bad_magic", "trailing_junk"])
def test_damaged_bytes_raise_port_error(stereo, cut):
    buf = stereo[1]
    bad = {"truncated": buf[: len(buf) // 2],
           "bad_magic": b"XXXX" + buf[4:],
           "trailing_junk": buf + b"junk"}[cut]
    with pytest.raises(ContainerError):
        decode_sela(bad, device="cpu")


def test_mono_mid_raises_port_error():
    rng = np.random.default_rng(3)
    w = WavData(44100, 16, [rng.integers(-1000, 1000, 300).astype(np.int32)])
    bad = _reserialize(ref_codec.encode_wav(w), _set(0, sftype=SF_MID))
    with pytest.raises(ContainerError):
        decode_sela(bad, device="cpu")


def test_permuted_subframes_decode(stereo):
    w, buf = stereo
    got = decode_sela(_reserialize(buf, lambda f, sfs: list(reversed(sfs))),
                      chunk_frames=8, device="cpu")
    for a, b in zip(got.channels, w.channels):
        np.testing.assert_array_equal(a, b)


def test_cli_decode_and_info(tmp_path, capsys):
    from sela_tpu.ref.wav import read_wav
    from sela_tpu_torch.cli import main

    w, buf = _stream("oracle_setg_tags")
    src, dst = tmp_path / "in.sela", tmp_path / "out.wav"
    src.write_bytes(buf)
    assert main(["decode", str(src), str(dst), "--cpu", "--chunk-frames", "2"]) == 0
    back = read_wav(str(dst))
    for a, b in zip(back.channels, w.channels):
        np.testing.assert_array_equal(a, b)
    assert main(["info", str(src)]) == 0
    out = capsys.readouterr().out
    assert "16-bit, 2 ch, 3 frames" in out and "tag title" in out
    src.write_bytes(buf[:-3])
    assert main(["decode", str(src), str(dst), "--cpu"]) == 2
