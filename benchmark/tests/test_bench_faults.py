"""A run with the timed path broken underneath the harness comes out not
correct: a step that returns its state unchanged (the previous call's
output), half of each batch left out, an answer altered where it is
produced. (A cell on one card has no exchange between cards to leave
out.)"""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from conftest import CELLS, SMALL


def _broken(step, fault: str, outputs):
    """`step` with `fault` planted; `outputs` picks the tensors it alters."""
    prev = []

    def run(*args, **kw):
        if fault == "half":                # the batch's second half left out
            args = list(args)
            x = args[0].clone()
            x[x.shape[0] // 2:] = 0
            args[0] = x
        out = step(*args, **kw)
        if fault == "stale":               # the previous call's output
            prev.append(out)
            return prev[-2] if len(prev) > 1 else out
        if fault == "alter":               # one value off by one
            for t in outputs(out):
                t[tuple(s // 2 for s in t.shape)] += 1
        return out

    return run


@pytest.mark.parametrize("fault", ["stale", "half", "alter"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from sela_tpu_torch.codec import encoder

    outputs = lambda o: [o["residues"], o["res16"]]   # noqa: E731
    monkeypatch.setattr(encoder, "encode_step",
                        _broken(encoder.encode_step, fault, outputs))
    out = harness.run_cell(cell, 4, 0.3, False, time.perf_counter(),
                           device="cpu", sizes=SMALL)
    assert not out["correct"], out["checks"]
