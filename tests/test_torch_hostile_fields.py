"""Structure-aware mutations of the port's three decode paths on the CPU.

tests/test_torch_hostile.py XORs random bytes, which seldom land on the few
bytes a decoder validates and never change a stream's length. The streams
here are aimed at the fields of a valid stream, read from its parsed
layout by chip_smoke.py's mutator (phase 14 runs the same mutations on the
card):

(a) aimed flips: a byte of one named field (FORMAT.md's header, frame and
    subframe fields, a coefficient or residue word, the SeTg trailer's and
    APEv2's fields) XORed with 1-255, drawn from a fixed hypothesis seed;
(b) field edits, re-serialized so that the scan gets past them, at the
    limits of FORMAT.md's decoder validation (a coefficient re-Rice-encoded,
    so that only the range check can refuse it);
(c) length changes: truncations at and inside each field, junk after the
    last frame or after a trailer, a second trailer, a last subframe one
    word short.

The base clips are tests/test_torch_hostile.py's five, mono16 and stereo24
each with a SeTg and an APEv2 trailer, and a 16-bit stereo clip of four
frames. Every stream goes through check_buffer (the port's three paths, their
sela_tpu counterparts and the oracle, under that file's four properties and
its two splits), and through two more properties:

5. stream prefix: where the oracle refuses a stream, decode_stream(buf, 1)
   yields the oracle's frames before the one it refuses, block by block, a
   block from an unchanged frame equal to the base clip's oracle PCM, and
   then raises the port's ContainerError (StreamingPlayer once too);
6. group damage: decode_files([A, buf, B]) with A and B valid files of buf's
   group raises iff the oracle refuses buf, before any device step, and so
   does sela_tpu's; where it accepts, each file equals its one-file decode.
"""
import functools
from unittest import mock

import pytest
import torch
from hypothesis import given, seed, settings, strategies as st

import chip_smoke as cs
from sela_tpu.codec import corpus as jax_corpus
from sela_tpu.format import SF_MID
from sela_tpu.ref import codec as ref_codec
from sela_tpu.ref import container as ref_container
from sela_tpu_torch.codec import corpus, pipeline, stream
from sela_tpu_torch.errors import ContainerError
from test_torch_hostile import (
    CLIPS, JAX_CHUNK, PORT, _equal, _run, _wav, check_buffer, clip)

FIELD_CLIPS = cs.field_clips(cs.hostile_clips())
FIELDS = {name: cs.stream_fields(buf) for name, buf in FIELD_CLIPS.items()}
CASES = cs.field_cases(FIELD_CLIPS)
# (a): every field of the 24-bit stereo clip, the partition ks of the v2
# clip, the trailers' fields, and the length fields of the multi-frame clip
FLIP_CASES = (
    [("stereo24", f) for f in cs.HEADER_FIELDS + cs.FRAME_FIELDS
     if f in FIELDS["stereo24"]]
    + [("partitioned16", "k_part")]
    + [("mono16_setg", f) for f in cs.SETG_FIELDS]
    + [("stereo24_apev2", f) for f in cs.APE_FIELDS]
    + [("multi16", f) for f in ("sync", "nw_coeff", "nw_res")])


@pytest.fixture(autouse=True, scope="module")
def iir_rows_once():
    """decode_step's plain IIR runs each (residues, coefficients) row once
    in this file. A row's samples depend on its residues and coefficients
    alone, so every path gets the values the plain IIR gives it; and the
    mutated streams carry the base clips' unchanged frames again and again,
    through five decodes each, where the plain IIR costs ~0.14 s a call."""
    real, rows = pipeline.iir_synthesize, {}

    def iir(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        keys = [(e[i].numpy().tobytes(), c[i].numpy().tobytes())
                for i in range(len(e))]
        todo = sorted({keys.index(k) for k in keys if k not in rows})
        if todo:
            for i, x in zip(todo, real(e[todo].contiguous(),
                                       c[todo].contiguous())):
                rows[keys[i]] = x
        return (torch.stack([rows[k] for k in keys]) if keys
                else real(e, c))

    with mock.patch.object(pipeline, "iir_synthesize", iir):
        yield


@functools.lru_cache(maxsize=None)
def partners(name: str) -> tuple:
    """Two valid files of the base clip's decode_files group, and their
    one-file decodes."""
    h = ref_container.parse_header(FIELD_CLIPS[name])
    a, b = cs.group_partners(h.channels, h.bits_per_sample > 24)
    return a, b, [_wav(corpus.decode_files([x], cs.GROUP_CHUNK,
                                           device="cpu")[0]) for x in (a, b)]


def check_prefix(name: str, buf: bytes) -> None:
    want = cs.prefix_reference(buf, FIELD_CLIPS[name])
    assert want is not None, "the oracle accepts the stream"
    fault = cs.stream_prefix_fault(want, *cs.stream_blocks(buf, "cpu", 1))
    assert fault is None, fault


def check_group(name: str, buf: bytes, accepted: dict) -> None:
    a, b, want = partners(name)
    with mock.patch.object(corpus, "decode_step",
                           wraps=corpus.decode_step) as step:
        got = _run(lambda x: [_wav(w) for w in corpus.decode_files(
            [a, x, b], cs.GROUP_CHUNK, device="cpu")], buf)
    ref = _run(lambda x: [_wav(w) for w in jax_corpus.decode_files(
        [a, x, b], JAX_CHUNK)], buf)
    if not accepted:
        assert isinstance(got, ContainerError), ("group accepted", got)
        assert step.call_count == 0, "a device step before the refusal"
        assert isinstance(ref, ValueError), ("sela_tpu's group accepted", ref)
        return
    assert not isinstance(got, Exception), ("group refused", got)
    assert not isinstance(ref, Exception), ("sela_tpu's group refused", ref)
    assert _equal(got[0], want[0]) and _equal(got[2], want[1]), \
        "a valid file of the group differs from its one-file decode"
    assert _equal(got[1], accepted["decode_files"]), \
        "the mutated file differs from its one-file decode"
    assert all(_equal(g, r) for g, r in zip(got, ref)), \
        "the group's PCM differs from sela_tpu's"


def check_stream(name: str, buf: bytes) -> dict:
    """check_buffer's four properties, then the stream prefix (where the
    oracle refuses buf) and the group damage."""
    accepted = check_buffer(buf)
    if not accepted:
        check_prefix(name, buf)
    check_group(name, buf, accepted)
    return accepted


# --- the clips ------------------------------------------------------------

def test_field_clips_are_the_fuzz_clips_with_trailers_and_frames():
    """chip_smoke.py's copies of the base clips are test_torch_hostile.py's
    byte for byte; the tagged clips carry their trailer, and the multi-frame
    clip four frames with LPC and mid/side subframes."""
    for name in CLIPS:
        assert FIELD_CLIPS[name] == clip(name), name
    for name in ("mono16", "stereo24"):
        for fmt in ("setg", "apev2"):
            buf = FIELD_CLIPS[f"{name}_{fmt}"]
            assert buf.startswith(clip(name))
            assert ref_container.read_tags(buf) == cs.FIELD_TAGS
    multi = FIELD_CLIPS["multi16"]
    assert ref_container.parse_header(multi).num_frames == 4
    assert {f for f, _ in FIELDS["multi16"]["coeff_word"]} == {0, 1, 2, 3}
    assert any(multi[off] == SF_MID
               for _, ((off, _),) in FIELDS["multi16"]["type"])


@pytest.mark.parametrize("name", [n for n in FIELD_CLIPS if n not in CLIPS])
def test_field_clips_decode_on_every_path(name):
    """The clips that tests/test_torch_hostile.py lacks, unmutated."""
    accepted = check_stream(name, FIELD_CLIPS[name])
    assert set(accepted) == set(PORT)


# --- (b) and (c) ----------------------------------------------------------

@pytest.mark.parametrize("name,field,edit", CASES,
                         ids=["-".join(c) for c in CASES])
def test_field_edit(name, field, edit):
    accepted = check_stream(name, cs.field_case(FIELD_CLIPS,
                                                (name, field, edit)))
    if edit == "permuted":   # FORMAT.md: any order; the channel byte decides
        want = _wav(ref_codec.decode_sela(FIELD_CLIPS[name]))
        assert _equal(accepted["decode_files"], want)


# --- (a) ------------------------------------------------------------------

@pytest.mark.parametrize("name,field", FLIP_CASES,
                         ids=["-".join(c) for c in FLIP_CASES])
@seed(20261018)
@settings(deadline=None, max_examples=2, database=None)
@given(data=st.data())
def test_aimed_flip(name, field, data):
    buf = cs.aimed_flip(FIELD_CLIPS[name], FIELDS[name], field,
                        lambda n: data.draw(st.integers(0, n - 1)))
    check_stream(name, buf)


# --- StreamingPlayer --------------------------------------------------------

@pytest.mark.parametrize("field,edit", [("coeff", "64"),
                                        ("nw_res", "last_short")])
def test_streaming_player_gives_the_blocks_then_the_error(field, edit):
    """The player's consumer gets decode_stream's blocks before the damage,
    then the port's ContainerError: mid-stream (frame 1 of 4) and after the
    last frame."""
    base = FIELD_CLIPS["multi16"]
    buf = cs.field_edit(base, field, edit)
    blocks, error = [], None
    try:
        for block in stream.StreamingPlayer(buf, 1, max_blocks=2,
                                            device="cpu"):
            blocks.append(block)
    except Exception as e:   # the property judges what was raised
        error = e
    assert len(blocks) == (1 if field == "coeff" else 4)
    fault = cs.stream_prefix_fault(cs.prefix_reference(buf, base), blocks,
                                   error)
    assert fault is None, fault
