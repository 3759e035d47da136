"""Port encode on the CPU against the JAX package, the oracle and the input.

(a) `codec.pipeline._render_rows`, given the JAX analysis' (order, q), is
    byte-identical to the JAX `_render_rows` (the jnp path, and the fused
    Pallas path in interpret mode) in every planning array;
(c) `codec.encoder.encode_wav(device="cpu")` streams decode bit-exactly
    through the numpy oracle `sela_tpu.ref.decode_sela`, the JAX decoder
    and the port's decoder, and are no more than 0.5% larger than the JAX
    encoder's (the float analysis is non-normative, so sizes may differ on
    near-ties);
(d) the pinned-corpus compression ratio holds (tests/data/pinned_ratio.json,
    +2% allowed, as the JAX package's own gate);
(e) the chunk engine frames each chunk straight into its slot
    (codec.encoder.frame_chunk) exactly as frame_batches frames the whole
    track, padding zeros included, over slots that held anything before;
    and streams whose slots are reused keep their bytes;
plus the profile checks: the partitioned render leaves silence
unpartitioned, and BitstreamProfile's validation errors are the JAX
package's. The encode_step comparison (b) is
tests/test_torch_encode_step.py; partitioned residues are
tests/test_torch_partition.py.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.codec import decoder as jax_decoder
from sela_tpu.codec import encoder as jax_encoder
from sela_tpu.codec.pipeline import _render_rows as jax_render_rows
from sela_tpu.config import BitstreamProfile as JaxProfile
from sela_tpu.kernels.encode import analyze_pallas
from sela_tpu.ref import codec as ref_codec
from sela_tpu.ref.wav import WavData
from sela_tpu_torch.codec import corpus
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.encoder import (PIPELINE, encode_wav, frame_batches,
                                          frame_chunk, frame_counts)
from sela_tpu_torch.codec.pipeline import _render_rows, encode_step
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.utils.metrics import Metrics

CHUNK = 8   # the JAX encoder's and decoder's chunk, as in the other tests
S = 2048
RENDER_KEYS = ("e", "eff_order", "q_eff", "k_res", "kr4", "k_coeff", "nw_res",
               "nw_coeff", "block_bits")


def _music(rng, n: int, C: int, bits: int) -> list[np.ndarray]:
    """Tones under noise, one level a channel, so mid/side is sometimes
    worth it and orders spread."""
    t = np.arange(n)
    base = np.sin(2 * np.pi * 330 * t / 44100) + 0.4 * np.sin(
        2 * np.pi * 831 * t / 44100)
    amp = 0.6 * ((1 << (bits - 1)) - 1)
    chans = []
    for c in range(C):
        noise = rng.normal(0, amp / (30 + 300 * c) + 1, n)
        x = amp * (0.9 - 0.2 * c) * base * np.exp(-t / (n / (1 + c))) + noise
        chans.append(np.clip(np.round(x), -(1 << (bits - 1)),
                             (1 << (bits - 1)) - 1).astype(np.int32))
    return chans


# ------------------------------------------------------------ (a) render --

@pytest.mark.parametrize("fused,k_max", [(False, 30), (False, 7), (True, 30)])
def test_render_rows_matches_jax_given_its_analysis(fused, k_max):
    rng = np.random.default_rng(11)
    B = 64
    chans = _music(rng, B * S // 2, 2, 24)
    xb = np.stack(chans).reshape(B, S)
    xb[5] = rng.integers(-(1 << 25), 1 << 25, S)      # a noisy, wide row
    xb[6] = 0                                          # silence
    nv = np.full(B, S, np.int32)
    nv[[3, 9, 10]] = (1000, 1, 0)
    xb[np.arange(S)[None, :] >= nv[:, None]] = 0
    xj, nvj = jnp.asarray(xb), jnp.asarray(nv)
    order, q, _ = analyze_pallas(xj, nvj, 32, interpret=True)
    want = jax_render_rows(xj, q, order, nvj, k_max, fused, True, 1)
    got = _render_rows(torch.from_numpy(xb), torch.from_numpy(np.array(q)),
                       torch.from_numpy(np.array(order)), torch.from_numpy(nv),
                       k_max)
    for key in RENDER_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert len(set(np.asarray(order).tolist())) > 3   # orders do vary


# --------------------------------------------------------- (c) encode_wav --

def _case(name: str):
    rng = np.random.default_rng(len(name))
    n = 4 * S + 123                                   # a tail frame
    if name == "16bit_stereo":
        return WavData(44100, 16, _music(rng, n, 2, 16)), None
    if name == "24bit_stereo_exact_ms":
        return (WavData(96000, 24, _music(rng, n, 2, 24)),
                BitstreamProfile(mid_side="exact"))
    if name == "32bit_stereo_extremes":
        chans = _music(rng, n, 2, 32)
        chans[0][100], chans[0][5000], chans[1][7] = (
            -(1 << 31), (1 << 31) - 1, -(1 << 31))
        return WavData(48000, 32, chans), None
    raise ValueError(name)


@pytest.mark.parametrize("name", ["16bit_stereo", "24bit_stereo_exact_ms",
                                  "32bit_stereo_extremes"])
def test_encode_wav_decodes_everywhere(name):
    w, profile = _case(name)
    buf = encode_wav(w, chunk_frames=2, profile=profile, device="cpu",
                     tags={"title": name})
    decoders = {
        "oracle": ref_codec.decode_sela,
        "jax": lambda b: jax_decoder.decode_sela(b, chunk_frames=CHUNK),
        "port": lambda b: decode_sela(b, chunk_frames=3, device="cpu"),
    }
    for who, dec in decoders.items():
        out = dec(buf)
        assert (out.sample_rate, out.bits_per_sample) == (
            w.sample_rate, w.bits_per_sample), who
        for a, b in zip(out.channels, w.channels):
            np.testing.assert_array_equal(a, b, err_msg=who)
    jax_profile = None if profile is None else JaxProfile(mid_side="exact")
    jax_buf = jax_encoder.encode_wav(w, chunk_frames=CHUNK, profile=jax_profile,
                                     tags={"title": name})
    assert len(buf) <= 1.005 * len(jax_buf), (len(buf), len(jax_buf))
    # the chunking is a runtime choice: it never changes the bytes
    assert encode_wav(w, chunk_frames=512, profile=profile, device="cpu",
                      tags={"title": name}) == buf


def test_frame_batches_match_jax():
    rng = np.random.default_rng(4)
    chans = [rng.integers(-900, 900, 3 * S + 5).astype(np.int32)
             for _ in range(3)]
    x, nv = frame_batches(chans, S)
    xw, nvw = jax_encoder.frame_batches(chans, S)
    np.testing.assert_array_equal(x, xw)
    np.testing.assert_array_equal(nv, nvw)


# ---------------------------------------------------- (d) pinned ratio --

def test_pinned_corpus_ratio():
    from sela_tpu.bench import make_corpus

    with open(os.path.join(os.path.dirname(__file__), "data",
                           "pinned_ratio.json")) as f:
        pinned = json.load(f)
    left, right = make_corpus(pinned["seconds"], seed=pinned["seed"])
    w = WavData(44100, 16, [left, right])
    buf = encode_wav(w, device="cpu")
    ratio = len(buf) / (w.n_samples * 2 * 2)
    assert ratio <= pinned["ratio"] * 1.02, ratio
    back = decode_sela(buf, device="cpu")
    for a, b in zip(back.channels, w.channels):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- (e) framing into the slots --

FS = 64   # a small frame: many frames and chunks from short clips
FRAMED = {  # a case's files' lengths in samples
    "whole_frames": [3 * FS],
    "one_over": [3 * FS + 1],
    "one_sample": [1],
    "group": [2 * FS + 7, 1, 5 * FS, 3 * FS + 33, FS - 1],
}


@pytest.mark.parametrize("case", sorted(FRAMED))
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("wire", [torch.int16, torch.int32],
                         ids=["int16", "int32"])
def test_frame_chunk_matches_frame_batches(case, C, wire):
    """Every chunk framed into a poisoned slot equals frame_batches' frames
    of the files one after another, padding zeros included, and each
    element of the chunk is written once."""
    rng = np.random.default_rng(len(case) + C)
    hi = 1 << (15 if wire == torch.int16 else 31)
    files = [[rng.integers(-hi, hi, n).astype(np.int32) for _ in range(C)]
             for n in FRAMED[case]]
    dtype = np.int16 if wire == torch.int16 else np.int32
    framed = [frame_batches(f, FS, dtype) for f in files]
    want = np.concatenate([x for x, _ in framed])
    counts, n_valid = frame_counts(FRAMED[case], FS)
    np.testing.assert_array_equal(counts, [len(x) for x, _ in framed])
    np.testing.assert_array_equal(n_valid,
                                  np.concatenate([nv for _, nv in framed]))
    first = np.concatenate([[0], np.cumsum(counts)])
    F = len(want)
    for chunk in sorted({1, 2, 3, F, F + 2}):
        slot = torch.empty((chunk, C, FS), dtype=wire)
        written = 0
        for start in range(0, F, chunk):
            stop = min(start + chunk, F)
            slot.fill_(-1)
            written += frame_chunk(slot, files, first, start, stop)
            np.testing.assert_array_equal(slot[:stop - start].numpy(),
                                          want[start:stop],
                                          err_msg=f"chunk {chunk} at {start}")
            assert (slot[stop - start:] == -1).all()   # nothing past it
        assert written == F * C * FS


def _reused(rng, n: int, C: int, bits: int) -> WavData:
    return WavData(44100, bits, _music(rng, n, C, bits))


@pytest.mark.parametrize("bits", [16, 24])
def test_reused_slots_keep_the_streams(bits):
    """encode_wav over more chunks than slots, its tail chunk's partial
    frame in a reused slot, and encode_files over a group whose files end
    mid-chunk: each file's stream is its one-chunk encode_wav stream,
    decodes exactly through the oracle, and framed_bytes counts each
    sample and pad once, F C S times the wire's size."""
    chunk, wire = 2, 2 if bits <= 16 else 4
    rng = np.random.default_rng(bits)
    track = _reused(rng, (2 * chunk * PIPELINE + 2) * FS + 5, 2, bits)
    F = -(-track.n_samples // FS)
    assert F > PIPELINE * chunk and F % chunk   # reused slots, a tail chunk
    m = Metrics()
    buf = encode_wav(track, frame_size=FS, chunk_frames=chunk, device="cpu",
                     metrics=m)
    assert buf == encode_wav(track, frame_size=FS, chunk_frames=F,
                             device="cpu")
    assert m.counters["framed_bytes"] == F * 2 * FS * wire
    group = [_reused(rng, n, 2, bits)
             for n in (3 * FS + 9, 2 * FS, 4 * FS + 1, 1, 5 * FS - 3)]
    group.append(track)
    m = Metrics()
    bufs = corpus.encode_files(group, chunk_frames=chunk, frame_size=FS,
                               device="cpu", metrics=m)
    frames = [-(-w.n_samples // FS) for w in group]
    assert m.counters["chunks"] > PIPELINE
    assert m.counters["framed_bytes"] == sum(frames) * 2 * FS * wire
    assert bufs[-1] == buf
    for w, b, f in zip(group, bufs, frames):
        assert b == encode_wav(w, frame_size=FS, chunk_frames=f,
                               device="cpu")
        back = ref_codec.decode_sela(b)
        for got, want in zip(back.channels, w.channels):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n1", [FS + 3, FS + 5])
def test_channels_of_unequal_length_are_refused(n1):
    w = WavData(44100, 16, [np.zeros(FS + 4, np.int32),
                            np.zeros(n1, np.int32)])
    with pytest.raises(ValueError, match="differ in length"):
        encode_wav(w, frame_size=FS, device="cpu")
    with pytest.raises(ValueError, match="differ in length"):
        corpus.encode_files([w], frame_size=FS, device="cpu")


# -------------------------------------------------------------- profile --

def test_partitioned_render_of_silence_is_unpartitioned():
    x = torch.zeros((1, 2, 64), dtype=torch.int32)
    out = encode_step(x, torch.full((1,), 64, dtype=torch.int32), partition=4)
    assert (out["k_res4"] == 0).all()     # silence: nothing to partition


BAD_PROFILES = [dict(frame_size=16), dict(frame_size=4096), dict(max_order=0),
                dict(max_order=33), dict(rice_k_max=-1), dict(rice_k_max=31),
                dict(mid_side="sometimes"), dict(residue_partition=2)]


@pytest.mark.parametrize("kw", BAD_PROFILES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_profile_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxProfile(**kw).validate()
    with pytest.raises(ValueError) as got:
        BitstreamProfile(**kw).validate()
    assert str(got.value) == str(want.value)
    assert BitstreamProfile().validate().is_v1_default


def test_cli_encode_and_verify(tmp_path, capsys):
    from sela_tpu.ref.wav import read_wav, write_wav
    from sela_tpu_torch.cli import main

    w, _ = _case("16bit_stereo")
    src, dst = tmp_path / "in.wav", tmp_path / "out.sela"
    write_wav(str(src), w)
    assert main(["encode", str(src), str(dst), "--cpu", "--chunk-frames",
                 "2", "--max-order", "12"]) == 0
    back = ref_codec.decode_sela(dst.read_bytes())
    for a, b in zip(back.channels, w.channels):
        np.testing.assert_array_equal(a, b)
    assert main(["verify", str(src), "--cpu", "--exact-mid-side"]) == 0
    assert main(["verify", str(src), "--cpu", "--no-mid-side",
                 "--rice-k-max", "9"]) == 0
    assert capsys.readouterr().out.count("BIT-EXACT") == 2
    assert read_wav(str(src)).n_samples == w.n_samples
