"""The reader of the encoder's `host_assemble` span, assemble_share.encode:
its value on a made-up context, nothing off its op or without the span,
and the span read in the CD cell's traced line."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.traffic import load_named
from conftest import SMALL

NAME = "assemble_share.encode"
STAGES = {"host_pack": 1.5, "emit": 0.3, "host_assemble": 0.1}


def _ctx(op="encode", stage_s=STAGES):
    return SimpleNamespace(op=op, records=[], window_s=2.0,
                           stage_s=dict(stage_s), trace=None,
                           stretch_bytes=0, peak_bytes_per_s=None)


def _read(ctx):
    return load_named("layer_metrics", NAME).read(ctx)


def test_value():
    assert _read(_ctx()) == pytest.approx(100 * 0.1 / 2.0)


@pytest.mark.parametrize("op", ["decode", "encode_files"])
def test_nothing_off_the_op(op):
    # decode_sela and encode_files time a host_assemble of their own
    assert _read(_ctx(op=op)) is None


def test_nothing_without_the_span():
    # what a program that assembles no stream in a stage records
    assert _read(_ctx(stage_s={"host_pack": 1.5, "emit": 0.3})) is None


def test_the_cd_cells_traced_line_reports_it():
    out = harness.run_cell("cd16_v1.ingest", 2147483711, 0.3, True,
                           time.perf_counter(), device="cpu", sizes=SMALL)
    assert out["correct"], out
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert 0 < got[NAME] < 100, got


def test_the_spec_lists_it_for_the_cd_cell_alone():
    spec = {m["name"]: m for m in harness.load_spec()["per_layer"]}
    assert spec[NAME]["workloads"] == ["cd16_v1.ingest"]
    assert spec[NAME]["moves"] == "encode_MBps"
