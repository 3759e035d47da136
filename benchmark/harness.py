"""One run of one cell: set-up, the measured window, the traced stretch, the
checks and the result line. Everything that belongs to a cell is found by
the names in BENCHMARK.json: `configs/<config>.json`, `mixes/<traffic>.json`
and the op it names (`ops/<op>.py`), `e2e_metrics/<metric>.py` and
`layer_metrics/<metric>.py`.
"""
from __future__ import annotations

import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sela_tpu")   # whole top-level names


class RunError(RuntimeError):
    """The run cannot give a result."""


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_cell(spec: dict, name: str, root: str = ROOT):
    """(workload entry, configuration, mix) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    wl = cells[name]
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", wl["config"] + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "mixes", wl["traffic"] + ".json")) as f:
        mix = json.load(f)
    return wl, cfg, mix


def cell_metrics(spec: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and per-layer metric entries this cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}

    def reports(m):
        return cell in m["workloads"] if "workloads" in m else (
            m["moves"] in moved)

    return e2e, [m for m in spec["per_layer"] if reports(m)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def peak_bytes_per_s(kind: str, root: str = ROOT):
    """The card's memory bandwidth from the table of peaks, or None."""
    with open(os.path.join(root, "benchmark", "peaks.json")) as f:
        return json.load(f).get(kind, {}).get("hbm_bytes_per_s")


def closed_loop(traffic, seconds: float, metrics, i: int):
    """The window of one caller: requests back to back until `seconds` have
    passed, the last one run to its end. An op may bring a `window` of its
    own with this signature (an open loop). Returns (records, failed
    requests, the next request's index)."""
    records, failed, t0 = [], 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        try:
            t_req = time.perf_counter()
            records.append(traffic.request(i, metrics))
            records[-1]["request_s"] = time.perf_counter() - t_req
        except Exception as e:   # a request that raises is counted, not fatal
            failed += 1
            print(f"request {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
        i += 1
    return records, failed, i


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", sizes: dict | None = None,
             root: str = ROOT) -> dict:
    """Run the cell once; returns the result object (its `checks` key last).

    t_start: perf_counter() when the process began, the start of set-up.
    sizes: {"config": {...}, "mix": {...}}, keys to replace: the tests run
    the cells at sizes a test run can hold. root: the checkout whose
    BENCHMARK.json and benchmark/ files name the cell."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from . import hoststate
    from .layer_metrics import bounds
    from .trace import REQUEST, profile_stretch, stage_recorder
    from .traffic import Traffic, load_named

    spec = load_spec(root)
    wl, cfg, mix = load_cell(spec, name, root)
    cfg = {**cfg, **(sizes or {}).get("config", {})}
    mix = {**mix, **(sizes or {}).get("mix", {})}
    e2e, layer = cell_metrics(spec, name)
    bench = os.path.join(root, "benchmark")
    cuda = torch.device(device).type == "cuda"

    if cuda:   # the CUDA context
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    t_made = time.perf_counter()
    traffic = Traffic(cfg, mix, seed, device, bench)
    t_pool = time.perf_counter()
    traffic.warm_up()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: imports and the device {t_made - t_start:.3f}"
          f", the pool {t_pool - t_made:.3f}, warm-up "
          f"{t_start + setup_s - t_pool:.3f}", file=sys.stderr)

    recorder = stage_recorder() if trace else None
    window = getattr(traffic.op, "window", closed_loop)
    host0 = hoststate.sample()
    t0 = time.perf_counter()
    records, failed, i = window(traffic, seconds, recorder, len(traffic.pool))
    window_s = time.perf_counter() - t0
    print(hoststate.describe(host0, hoststate.sample()), file=sys.stderr)
    if records:
        q = np.quantile([r.get("request_s", 0.0) for r in records],
                        [0, .25, .5, .75, 1])
        print("request seconds: min, quartiles, max " + " ".join(
            f"{v:.4f}" for v in q), file=sys.stderr)
    stage_s = dict(recorder.stage_s) if trace else {}
    attempted = len(records) + failed
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    summary, stretch = None, []
    if trace:
        def run():
            nonlocal i
            for _ in range(mix["trace_requests"]):
                with record_function(REQUEST):
                    stretch.append(traffic.request(i, recorder))
                i += 1

        summary = profile_stretch(run, device)

    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = traffic.checks(records + stretch, failed)
    print(f"checks {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())

    metrics = {}
    if not trace:
        for m in e2e:
            value = (setup_s if m["name"] == "setup_s" else load_named(
                "e2e_metrics", m["name"], bench).read(records, window_s))
            if value is None:
                raise RunError(f"{name} measures no {m['name']}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(
            op=traffic.op_name, records=records, window_s=window_s,
            stage_s=stage_s, trace=summary,
            stretch_bytes=sum(bounds.codec_bytes(
                r.get("encoded_pcm", 0), r.get("coded", 0))
                for r in stretch),
            peak_bytes_per_s=peak_bytes_per_s(
                torch.cuda.get_device_name() if cuda else "cpu", root))
        for m in layer:
            value = load_named("layer_metrics", m["name"], bench).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
