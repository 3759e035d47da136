"""The verify cell, cd16_v1.verify, at a size a test run can hold: plain and
traced runs come out correct, the traced line reports the per-layer
metrics the CPU can give, the control and planted faults (a stale output,
a dropped last frame, an altered header depth) come out caught, and the
readers read nothing off their op."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.control import controlled
from benchmark.traffic import load_named
from conftest import SMALL

CELL = "cd16_v1.verify"
STAGES = ("host_parse_share.decode", "host_unpack_share.decode",
          "dispatch_share.decode", "fetch_share.decode",
          "assemble_share.decode")
ON_THE_CPU = STAGES + ("rice_unpack_share.decode", "int32_wire_share.decode",
                       "decode_MBps.traced")
ON_THE_CARD = ("device_idle_share.decode", "decode_kernels_roofline")
CHECKS = {"mismatched_samples", "header_mismatches", "size_mismatches",
          "stream_mismatches", "undecodable_streams", "failed_requests"}


def _run(seed, trace):
    return harness.run_cell(CELL, seed, 0.3, trace, time.perf_counter(),
                            device="cpu", sizes=SMALL)


def _value(out, check):
    return out["checks"][check]["value"]


def test_plain_run_is_correct():
    out = _run(2147483659, False)
    assert out["correct"], out["checks"]
    # the decode rate spreads too widely for a bound: per layer only
    assert set(out["metrics"]) == {"ratio", "setup_s"}
    assert set(out["checks"]) == CHECKS
    assert 0 < out["metrics"]["ratio"]["value"] < 1


def test_traced_line_reports_what_the_cpu_gives():
    out = _run(7, True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(ON_THE_CPU), sorted(got)
    shares = [got[k] for k in STAGES]
    assert all(0 <= s <= 100 for s in shares) and sum(shares) <= 100
    assert got["rice_unpack_share.decode"] <= got["host_unpack_share.decode"]
    assert got["int32_wire_share.decode"] == 0   # CD residues fit int16
    assert got["decode_MBps.traced"] > 0


def test_spec_lists_every_reader_for_the_cell():
    e2e, layer = harness.cell_metrics(harness.load_spec(), CELL)
    assert {m["name"] for m in e2e} == {"ratio", "setup_s"}
    assert {m["name"] for m in layer} == set(ON_THE_CPU + ON_THE_CARD)


def test_control_is_not_correct():
    with controlled(CELL):
        out = _run(1, False)
    assert not out["correct"]
    assert _value(out, "mismatched_samples") > 0
    # the streams are sound and the headers kept: the decoder alone is wrong
    assert _value(out, "stream_mismatches") == 0
    assert _value(out, "header_mismatches") == 0


def test_control_puts_the_program_back():
    from sela_tpu_torch.codec import decoder

    sound = decoder.decode_sela
    with controlled(CELL):
        assert decoder.decode_sela is not sound
    assert decoder.decode_sela is sound


def _planted(sound, fault: str):
    from sela_tpu_torch.format import FRAME_SIZE
    from sela_tpu_torch.ref.wav import WavData

    prev = []

    def run(buf, **kw):
        w = sound(buf, **kw)
        if fault == "stale":          # the previous request's output
            prev.append(w)
            return prev[-2] if len(prev) > 1 else w
        if fault == "last_frame":     # the last frame dropped
            keep = w.n_samples - (w.n_samples % FRAME_SIZE or FRAME_SIZE)
            return WavData(w.sample_rate, w.bits_per_sample,
                           [c[:keep] for c in w.channels])
        return WavData(w.sample_rate, 24, w.channels)   # the header's depth

    return run


@pytest.mark.parametrize("fault", ["stale", "last_frame", "depth"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    from sela_tpu_torch.codec import decoder

    monkeypatch.setattr(decoder, "decode_sela",
                        _planted(decoder.decode_sela, fault))
    out = _run(3, False)
    assert not out["correct"], out["checks"]
    assert _value(out, "stream_mismatches") == 0
    if fault == "depth":
        assert _value(out, "header_mismatches") > 0
        assert _value(out, "mismatched_samples") == 0
    else:
        assert _value(out, "mismatched_samples") > 0
    if fault != "stale":
        assert _value(out, "size_mismatches") == out["attempted"]


STAGE_S = {"host_parse": 0.1, "host_unpack": 1.0, "rice_unpack": 0.4,
           "device_dispatch": 0.2, "device_fetch": 0.3, "host_assemble": 0.2}


def _ctx(op="decode", stage_s=STAGE_S, records=()):
    return SimpleNamespace(op=op, records=list(records), window_s=2.0,
                           stage_s=dict(stage_s), trace=None,
                           stretch_bytes=0, peak_bytes_per_s=None)


def _read(name, ctx):
    return load_named("layer_metrics", name).read(ctx)


def test_reader_values():
    ctx = _ctx(records=[
        {"decoded_pcm": 3_000_000, "counters": {"chunks": 6,
                                                "int32_wire_chunks": 1}},
        {"decoded_pcm": 1_000_000, "counters": {"chunks": 2}},
        {"decoded_pcm": 0, "counters": None}])
    for name, stage in zip(STAGES + ("rice_unpack_share.decode",),
                           ("host_parse", "host_unpack", "device_dispatch",
                            "device_fetch", "host_assemble", "rice_unpack")):
        assert _read(name, ctx) == pytest.approx(100 * STAGE_S[stage] / 2.0)
    assert _read("int32_wire_share.decode", ctx) == pytest.approx(12.5)
    assert _read("decode_MBps.traced", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ON_THE_CPU + ON_THE_CARD)
def test_readers_read_nothing_off_their_op(name):
    encode = [{"encoded_pcm": 10, "coded": 5, "counters": {"chunks": 1}}]
    assert _read(name, _ctx(op="encode", records=encode)) is None
    # what a program without decode_sela's spans and counters records
    assert _read(name, _ctx(stage_s={}, records=[{"counters": None,
                                                  "out": None}])) is None
