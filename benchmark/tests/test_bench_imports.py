"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port either; names compare whole, by the
part before the first dot (`sela_tpu_torch` begins with `sela_tpu`)."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import harness
from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _loaded(code: str) -> set[str]:
    """Top-level names of every module a fresh interpreter holds after
    running `code` from the root of the checkout."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_no_jax():
    names = _loaded(
        "import time\nfrom benchmark import harness\n"
        "harness.run_cell('hires24_v2.ingest', 3, 0.2, True, time.perf_counter(),"
        " device='cpu', sizes={'config': {'track_seconds': 1.0}})\n")
    assert "sela_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "sela_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = _loaded(
        "from benchmark.reference import decode\n"
        "from benchmark.layer_metrics import bounds\n")
    assert not names & {"jax", "jaxlib", "flax", "sela_tpu",
                        "sela_tpu_torch", "torch"}


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                names = _imports(os.path.join(d, f))
                assert not names & {"jax", "jaxlib", "flax", "sela_tpu"}, f
    ref = _imports(os.path.join(BENCH, "reference", "decode.py"))
    assert ref <= {"__future__", "struct", "numpy"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sela_tpu_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sela_tpu.codec", sys)
    assert harness.forbidden_modules() == ["sela_tpu"]
