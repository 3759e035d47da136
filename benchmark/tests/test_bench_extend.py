"""A later change adds a cell as new files and new entries, editing no file
that is there: shown in a copy of the benchmark, once with a throwaway mix
of an op that is there and a per-layer reader, once with a throwaway op of
its own (with a window of its own, an open loop), its mix, a new
end-to-end metric's reader and a per-layer reader."""
from __future__ import annotations

import json
import os
import shutil
import time

import pytest

from benchmark import harness
from conftest import ROOT, SMALL

FIRST_OP = '''"""first: decode_stream of a pool stream to its first block, then close;
listeners arrive on a clock of their own (an open loop)."""
import time

from benchmark.traffic import encode_pool, mismatch


def setup(t):
    return encode_pool(t)


def request(t, i, metrics):
    from sela_tpu_torch.codec import stream

    track = t.track(i)
    t0 = time.perf_counter()
    blocks = stream.decode_stream(t.state[track],
                                  chunk_frames=t.mix["chunk_frames"],
                                  device=t.device)
    block = next(blocks)
    first = time.perf_counter() - t0
    blocks.close()
    return dict(track=track, first_s=first, started=t0,
                out=block if t.kept(i) else None)


def checks(t, records):
    bad = sum(mismatch([c[:len(r["out"])] for c in t.pool[r["track"]].channels],
                       list(r["out"].T))
              for r in records if r["out"] is not None)
    return {"mismatched_samples": (bad, 0)}


def control():
    return []


def window(t, seconds, metrics, i):
    """An open loop: a request every 20 ms, its latency from its arrival."""
    records, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        due = t0 + 0.02 * len(records)
        time.sleep(max(0.0, due - time.perf_counter()))
        r = request(t, i, metrics)
        r["first_s"] += r.pop("started") - due
        records.append(r)
        i += 1
    return records, 0, i
'''

P50 = '''import numpy as np


def read(records, window_s):
    ms = [r["first_s"] * 1e3 for r in records if "first_s" in r]
    return float(np.median(ms)) if ms else None
'''

CASES = {
    # a mix of the encode op that is there, on a larger pool
    "ingest3": dict(op=None, mix={
        "op": "encode", "why": "an ingest that cycles three tracks",
        "pool_tracks": 3, "keep_share": 1.0, "trace_requests": 2},
        e2e=None, moves="encode_MBps"),
    # an op of its own, with a window and an end-to-end metric of its own
    "first": dict(op=("first", FIRST_OP), mix={
        "op": "first", "why": "a listener who hears only the first block",
        "pool_tracks": 2, "chunk_frames": 2, "keep_share": 1.0,
        "trace_requests": 2}, e2e=("first_audio_ms_p50", P50),
        moves="first_audio_ms_p50"),
}


@pytest.mark.parametrize("mix", sorted(CASES))
def test_new_cell_from_files_and_entries(mix, tmp_path):
    case = CASES[mix]
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    cell, layer = f"cd16_v1.{mix}", f"first_block_count.{mix}"
    (bench / "mixes" / f"{mix}.json").write_text(json.dumps(case["mix"]))
    (bench / "layer_metrics" / f"{layer}.py").write_text(
        "def read(ctx):\n    return float(ctx.stage_s is not None)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": cell, "config": "cd16_v1",
                              "traffic": mix, "chips": 1,
                              "why": "a throwaway cell"})
    if case["op"]:
        name, code = case["op"]
        (bench / "ops" / f"{name}.py").write_text(code)
    if case["e2e"]:
        name, code = case["e2e"]
        (bench / "e2e_metrics" / f"{name}.py").write_text(code)
        spec["end_to_end"].insert(0, {
            "name": name, "unit": "ms", "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": []})
    for m in spec["end_to_end"]:
        if m["name"] == case["moves"]:
            m["workloads"].append(cell)
    spec["per_layer"].append({
        "name": layer, "unit": "1", "better": "higher",
        "source": "host_clock", "layer": "host orchestration",
        "moves": case["moves"], "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    # no file that was there changed, but for BENCHMARK.json's entries
    edited = [p for p, b in before.items() if p.read_bytes() != b]
    assert edited == [tmp_path / "BENCHMARK.json"]

    for trace in (False, True):
        out = harness.run_cell(cell, 9, 0.3, trace, time.perf_counter(),
                               device="cpu",
                               sizes={"config": SMALL["config"]},
                               root=str(tmp_path))
        assert out["correct"], out
        assert set(out["metrics"]) == (
            {layer} if trace else {case["moves"], "setup_s"})
        for m in out["metrics"].values():
            assert m["value"] > 0
