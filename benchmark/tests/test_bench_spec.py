"""BENCHMARK.json keeps to the benchmark's contract: its keys, names,
units and limits, and every name it gives has its file."""
from __future__ import annotations

import json
import os
import re

from benchmark import harness
from conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SPEC = harness.load_spec()


def test_keys():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
             + [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.fullmatch(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c[k] for c in SPEC["configs"] for k in ("source", "why")]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]]
                 + SPEC["command"]):
        assert TEXT.fullmatch(text), text
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[group]}) == len(SPEC[group])
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_limits():
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_every_name_has_its_file():
    bench = os.path.join(ROOT, "benchmark")
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        mix = os.path.join(bench, "mixes", w["traffic"] + ".json")
        with open(mix) as f:
            op = json.load(f)["op"]
        assert os.path.exists(os.path.join(bench, "ops", op + ".py"))
    for m in SPEC["end_to_end"]:
        if m["name"] != "setup_s":   # the harness's own clock
            assert os.path.exists(os.path.join(bench, "e2e_metrics",
                                               m["name"] + ".py"))
    for m in SPEC["per_layer"]:
        assert os.path.exists(os.path.join(bench, "layer_metrics",
                                           m["name"] + ".py"))


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e, layer = harness.cell_metrics(SPEC, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:   # a per-layer metric moves what its cell reports
            assert m["moves"] in names, (w["name"], m["name"])
