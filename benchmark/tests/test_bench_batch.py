"""The batch cell, batch64_mixed.ingest_batch, at a size a test run can
hold: plain and traced runs come out correct, the traced line reports the
per-layer metrics the CPU can give, the control and a stream with an
altered header come out caught, and the readers read nothing off their
op."""
from __future__ import annotations

import json
import os
import struct
import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.control import controlled
from benchmark.traffic import load_named
from conftest import ROOT

CELL = "batch64_mixed.ingest_batch"
# six files of 0.02-0.3 s (one frame or less up to four), every format
# draw as the configuration's; small chunks, so a group spans several; a
# two-request traced stretch, every output kept
with open(os.path.join(ROOT, "benchmark", "configs",
                       "batch64_mixed.json")) as f:
    BATCH = {**json.load(f)["batch"], "files": 6, "seconds": [0.02, 0.3]}
SMALL_BATCH = {"config": {"batch": BATCH},
               "mix": {"trace_requests": 2, "keep_share": 1.0,
                       "chunk_frames": 4}}
ON_THE_CPU = ("host_frame_share.files", "dispatch_share.files",
              "fetch_share.files", "host_pack_share.files",
              "bitio_share.files", "int32_wire_share.files",
              "residue_bits_per_sample.files", "encode_MBps.files_traced")
ON_THE_CARD = ("device_idle_share.files", "encode_files_kernels_roofline")


def _run(seed, trace):
    return harness.run_cell(CELL, seed, 0.3, trace, time.perf_counter(),
                            device="cpu", sizes=SMALL_BATCH)


def test_plain_run_is_correct():
    out = _run(2147483659, False)
    assert out["correct"], out["checks"]
    # the batch's rate spreads too widely for a bound: per layer only
    assert set(out["metrics"]) == {"ratio", "setup_s"}
    assert set(out["checks"]) == {"mismatched_samples", "undecodable_streams",
                                  "header_mismatches", "missing_streams",
                                  "failed_requests"}
    assert 0 < out["metrics"]["ratio"]["value"] < 1


def test_traced_line_reports_what_the_cpu_gives():
    out = _run(7, True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == set(ON_THE_CPU), sorted(got)
    shares = [got[k] for k in ON_THE_CPU[:4]]
    assert all(0 <= s <= 100 for s in shares) and sum(shares) <= 100
    assert got["bitio_share.files"] <= got["host_pack_share.files"]
    assert 0 <= got["int32_wire_share.files"] <= 100
    assert got["residue_bits_per_sample.files"] > 0
    assert got["encode_MBps.files_traced"] > 0


def test_spec_lists_every_reader_for_the_cell():
    _, layer = harness.cell_metrics(harness.load_spec(), CELL)
    assert {m["name"] for m in layer} == set(ON_THE_CPU + ON_THE_CARD)


def test_control_is_not_correct():
    with controlled(CELL):
        out = _run(1, False)
    assert not out["correct"]
    assert out["checks"]["mismatched_samples"]["value"] > 0
    assert out["checks"]["header_mismatches"]["value"] == 0


def test_control_puts_the_program_back():
    from sela_tpu_torch.codec import corpus

    sound = corpus.encode_files
    with controlled(CELL):
        assert corpus.encode_files is not sound
    assert corpus.encode_files is sound


def test_a_batch_left_half_unencoded_is_not_correct(monkeypatch):
    from sela_tpu_torch.codec import corpus

    sound = corpus.encode_files

    def half(wavs, **kw):
        return sound(wavs[:len(wavs) // 2], **kw)

    monkeypatch.setattr(corpus, "encode_files", half)
    out = _run(3, False)
    assert not out["correct"]
    # every request drops three of its six files; the streams that came
    # back are each right
    assert out["checks"]["missing_streams"]["value"] == 3 * out["attempted"]
    assert out["checks"]["mismatched_samples"]["value"] == 0


def _op():
    return load_named("ops", "encode_files")


def test_an_altered_rate_is_a_header_mismatch():
    from sela_tpu_torch.codec import corpus
    from sela_tpu_torch.ref.wav import WavData

    op = _op()
    cfg = {"batch": {**BATCH, "files": 3}, "audio": {"recipe_seed": 5}}
    wavs = op.make_batch(cfg, 0, 11, "cpu")
    bufs = corpus.encode_files(wavs, device="cpu")
    t = SimpleNamespace(state=[wavs])
    assert op.checks(t, [dict(track=0, streams=3, out=bufs)]) == {
        "mismatched_samples": (0, 0), "undecodable_streams": (0, 0),
        "header_mismatches": (0, 0), "missing_streams": (0, 0)}
    # the header's rate (bytes 4-7, FORMAT.md) altered, every sample right
    bad = bytearray(bufs[1])
    struct.pack_into("<I", bad, 4, wavs[1].sample_rate + 1)
    got = op.checks(t, [dict(track=0, streams=3,
                             out=[bufs[0], bytes(bad), bufs[2]])])
    assert got["header_mismatches"] == (1, 0)
    assert got["mismatched_samples"] == (0, 0)
    # files of one channel whose streams hold two (the recipe draws three
    # stereo files here): every header and the extra channels wrong
    assert all(w.n_channels == 2 for w in wavs)
    mono = [WavData(w.sample_rate, w.bits_per_sample, w.channels[:1])
            for w in wavs]
    got = op.checks(SimpleNamespace(state=[mono]),
                    [dict(track=0, streams=3, out=bufs)])
    assert got["header_mismatches"] == (3, 0)
    assert got["mismatched_samples"][0] == sum(w.n_samples for w in wavs)


def test_a_batch_keeps_its_formats_across_seeds():
    op = _op()
    cfg = {"batch": {**BATCH, "files": 5}, "audio": {"recipe_seed": 8}}

    def formats(wavs):
        return [(w.sample_rate, w.bits_per_sample, w.n_channels, w.n_samples)
                for w in wavs]

    a, b = (op.make_batch(cfg, 1, seed, "cpu") for seed in (3, 1 << 40))
    assert formats(a) == formats(b)
    assert any((x.channels[0] != y.channels[0]).any() for x, y in zip(a, b))
    assert formats(op.make_batch(cfg, 0, 3, "cpu")) != formats(a)


STAGES = {"host_frame": 0.2, "device_dispatch": 0.4, "device_fetch": 0.1,
          "host_pack": 1.0, "rice_count": 0.3, "rice_pack": 0.5}


def _ctx(op="encode_files", stage_s=STAGES, records=()):
    return SimpleNamespace(op=op, records=list(records), window_s=2.0,
                           stage_s=dict(stage_s), trace=None,
                           stretch_bytes=0, peak_bytes_per_s=None)


def _read(name, ctx):
    return load_named("layer_metrics", name).read(ctx)


def test_reader_values():
    ctx = _ctx(records=[{"counters": {"chunks": 3, "int32_fetch": 1}},
                        {"counters": {"chunks": 1}}, {"counters": None}])
    for name, stage in (("host_frame_share.files", "host_frame"),
                        ("dispatch_share.files", "device_dispatch"),
                        ("fetch_share.files", "device_fetch"),
                        ("host_pack_share.files", "host_pack")):
        assert _read(name, ctx) == pytest.approx(100 * STAGES[stage] / 2.0)
    assert _read("bitio_share.files", ctx) == pytest.approx(40.0)
    assert _read("int32_wire_share.files", ctx) == pytest.approx(25.0)
    ctx.records = [{"encoded_pcm": 3_000_000}, {"encoded_pcm": 1_000_000}]
    assert _read("encode_MBps.files_traced", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ON_THE_CPU + ON_THE_CARD)
def test_readers_read_nothing_off_their_op(name):
    assert _read(name, _ctx(op="encode")) is None
    # what a program without encode_files' spans and counters records
    assert _read(name, _ctx(stage_s={}, records=[{"counters": None,
                                                  "out": None}])) is None
