"""The command as the checks run it: no result without the cards the cell
asks for, none from a directory that holds only the benchmark, and on a
card a result line with every key."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

ARGS = ["--workload", "cd16_v1.ingest", "--seed", "2147483659",
        "--seconds", "2", "--trace", "0"]


def _run(cwd) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card" in out.stderr


@pytest.mark.cuda
def test_result_line_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] and res["failed"] == 0
    assert set(res["metrics"]) == {"encode_MBps", "ratio", "setup_s"}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
