"""The plain reference decoder against the port's numpy oracle, on small
v1 and v2 clips at every depth, and its refusals."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.reference.decode import StreamError, decode
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.ref import codec as oracle
from sela_tpu_torch.ref.wav import WavData


def _clip(bits: int, channels: int, n: int, seed: int) -> WavData:
    """Tones under noise at 0.6 of full scale, the last channel partly the
    first's, and a silent stretch; 32-bit clips also hold INT32_MIN/MAX."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    full = (1 << (bits - 1)) - 1
    base = np.sin(2 * np.pi * t / 37.0) + 0.3 * np.sin(2 * np.pi * t / 5.3)
    chans = []
    for c in range(channels):
        x = 0.6 * base * (1 - 0.3 * c) + rng.normal(0, 0.02 * (c + 1), n)
        x[n // 3: n // 3 + 300] = 0
        chans.append(np.clip(np.round(x * full), -full - 1, full)
                     .astype(np.int32))
    if bits == 32:
        chans[0][5], chans[0][6] = -(1 << 31), (1 << 31) - 1
    return WavData(8000 * bits // 8, bits, chans)


@pytest.mark.parametrize("partition", [1, 4])
@pytest.mark.parametrize("bits,channels,n", [
    (8, 1, 700), (16, 2, 4500), (24, 2, 2100), (32, 2, 2048), (16, 3, 3000),
])
def test_reference_equals_oracle(bits, channels, n, partition):
    w = _clip(bits, channels, n, seed=bits * 10 + channels)
    buf = oracle.encode_wav(w, profile=BitstreamProfile(
        residue_partition=partition))
    want = oracle.decode_sela(buf)
    rate, depth, got = decode(buf)
    assert (rate, depth) == (want.sample_rate, want.bits_per_sample)
    assert len(got) == len(want.channels)
    for a, b in zip(got, want.channels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, w.channels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("partition", [1, 4])
def test_reference_decodes_the_ports_cpu_stream(partition):
    from sela_tpu_torch.codec.encoder import encode_wav

    w = _clip(16, 2, 9000, seed=3)
    buf = encode_wav(w, profile=BitstreamProfile(residue_partition=partition),
                     device="cpu")
    for a, b in zip(decode(buf)[2], w.channels):
        np.testing.assert_array_equal(a, b)


def test_reference_first_frames():
    w = _clip(16, 2, 4500, seed=4)
    buf = oracle.encode_wav(w)
    got = decode(buf, max_frames=2)[2]
    for a, b in zip(got, w.channels):
        np.testing.assert_array_equal(a, b[:4096])


def test_float32_control_breaks_exactness():
    w = _clip(16, 2, 4500, seed=5)
    got = decode(oracle.encode_wav(w), iir_dtype=np.float32)[2]
    assert any(np.any(a != b) for a, b in zip(got, w.channels))


@pytest.mark.parametrize("damage", [
    "magic", "sync", "truncate", "trailing", "order", "k_res", "nwords",
])
def test_reference_refuses(damage):
    w = _clip(16, 2, 4500, seed=6)
    buf = bytearray(oracle.encode_wav(w))
    sub = 15 + 6                     # the first subframe's header
    if damage == "magic":
        buf[0] ^= 1
    elif damage == "sync":
        buf[15] ^= 1
    elif damage == "truncate":
        del buf[-3:]
    elif damage == "trailing":
        buf += b"\0\0\0\0"
    elif damage == "order":
        buf[sub + 2] = 33
    elif damage == "k_res":
        nwc = int.from_bytes(buf[sub + 4:sub + 6], "little")
        buf[sub + 6 + 4 * nwc] = 40
    elif damage == "nwords":         # one residue word fewer than its bits
        nwc = int.from_bytes(buf[sub + 4:sub + 6], "little")
        at = sub + 6 + 4 * nwc + 1
        nwr = int.from_bytes(buf[at:at + 4], "little")
        buf[at:at + 4] = (nwr - 1).to_bytes(4, "little")
    with pytest.raises(StreamError):
        decode(bytes(buf))
