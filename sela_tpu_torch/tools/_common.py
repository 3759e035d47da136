"""What the port's tools share: their inputs (the JAX tools' corpus
frames) and their timing. On the card a time is CUDA events around calls
queued behind a device-side sleep (bench._device_ms), the minimum of
REPEATS; on the CPU, one call on the host clock (its numbers say nothing
of the card)."""
from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

from ..bench import _device_ms, _device_names, make_corpus
from ..codec.encoder import frame_batches

REPEATS = 5
# the checkout's root: the tools' subprocesses run `python -m` from it
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def device_ms(fn, dev: torch.device, iters: int = 10) -> float:
    """ms per call of fn on `dev`: the minimum of REPEATS passes of `iters`
    back-to-back calls on the card; one call on the CPU."""
    if dev.type != "cuda":
        return _device_ms(fn, 1, dev)
    return min(_device_ms(fn, iters, dev) for _ in range(REPEATS))


def device_record(dev: torch.device) -> dict:
    """The device a tool ran on: its name and power limit, and for the card
    its SM count and maximum SM clock (MHz)."""
    rec = _device_names(dev)
    if dev.type == "cuda":
        rec["sm_count"] = torch.cuda.get_device_properties(dev).multi_processor_count
        rec["max_sm_clock_mhz"] = smi_number("clocks.max.sm", dev)
    return rec


def smi_number(field: str, dev: torch.device) -> float | None:
    """One numeric nvidia-smi field of the card (None if it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits",
             f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sm_clock_under_load(fn, dev: torch.device, calls: int) -> float | None:
    """The SM clock (MHz) that nvidia-smi reads while `calls` calls of fn
    run on the card (None on the CPU or if it cannot be read)."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    for _ in range(calls):
        fn()
    clock = smi_number("clocks.sm", dev)
    torch.cuda.synchronize(dev)
    return clock


def corpus_frames(F: int, seconds: float = 120.0):
    """The JAX tools' input: F frames of the bench corpus (`seconds` long,
    repeated as needed) -> (x [F, 2, 2048] int32, n_valid [F] int32)."""
    x, n_valid = frame_batches(list(make_corpus(seconds)))
    reps = -(-F // len(x))
    return (np.ascontiguousarray(np.concatenate([x] * reps)[:F]),
            np.concatenate([n_valid] * reps)[:F])


def candidate_rows(x: np.ndarray, n_valid: np.ndarray):
    """The JAX roofline's and sweep_kernels' 4F rows: the F frames' 2F
    channel rows twice -> (xb [4F, S], nv [4F]) int32."""
    F, C, S = x.shape
    B = F * 4
    xb = np.ascontiguousarray(np.tile(x.reshape(F * C, S), (2, 1))[:B])
    nv = np.tile(n_valid.repeat(C), 2)[:B].astype(np.int32)
    return xb, nv


def emit(rec: dict, out: str | None) -> None:
    """Print a tool's one JSON line on stdout and, given a path, write it
    there (the only file a tool writes)."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
