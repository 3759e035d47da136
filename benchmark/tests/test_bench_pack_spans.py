"""The readers of the spans inside the encoder's `host_pack`: their values
on a made-up context, nothing off their op or without their spans, and all
six in the CD cell's traced line."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.traffic import load_named
from conftest import SMALL

SHARES = {"pack_gather_share.encode": "pack_gather",
          "rice_count_share.encode": "rice_count",
          "rice_pack_share.encode": "rice_pack",
          "emit_share.encode": "emit"}
READERS = (*SHARES, "pack_threads.encode", "pack_on_cpu_share.encode")
STAGES = {"host_pack": 1.5, "pack_gather": 0.5, "rice_count": 0.1,
          "rice_pack": 0.3, "emit": 0.05, "bitio_workers": 1.6,
          "bitio_workers_on_cpu": 1.2}


def _ctx(op="encode", stage_s=STAGES):
    return SimpleNamespace(op=op, records=[], window_s=2.0,
                           stage_s=dict(stage_s), trace=None,
                           stretch_bytes=0, peak_bytes_per_s=None)


def _read(name, ctx):
    return load_named("layer_metrics", name).read(ctx)


def test_values():
    ctx = _ctx()
    for name, stage in SHARES.items():
        assert _read(name, ctx) == pytest.approx(100 * STAGES[stage] / 2.0)
    assert _read("pack_threads.encode", ctx) == pytest.approx(1.6 / 0.4)
    assert _read("pack_on_cpu_share.encode", ctx) == pytest.approx(75.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_off_the_op_or_without_the_spans(name):
    assert _read(name, _ctx(op="decode")) is None
    # what a program without the spans records: host_pack alone
    assert _read(name, _ctx(stage_s={"host_pack": 1.5})) is None


def test_the_cd_cells_traced_line_reports_all_six():
    out = harness.run_cell("cd16_v1.ingest", 2147483659, 0.3, True,
                           time.perf_counter(), device="cpu", sizes=SMALL)
    assert out["correct"], out
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(got), sorted(got)
    assert sum(got[k] for k in SHARES) <= got["host_pack_share.encode"]
    assert got["pack_threads.encode"] > 0
    # the thread CPU clock may step by 10 ms: a short window can read 0
    assert got["pack_on_cpu_share.encode"] >= 0
