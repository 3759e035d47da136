"""The control, at a size a test run can hold: the program swapped for a
version that breaks the lossless guarantee must come out not correct."""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.control import controlled
from conftest import CELLS, SMALL


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    for seed in (1, 2):
        with controlled(cell):
            out = harness.run_cell(cell, seed, 0.3, False,
                                   time.perf_counter(), device="cpu",
                                   sizes=SMALL)
        assert not out["correct"]
        assert out["checks"]["mismatched_samples"]["value"] > 0


def test_control_puts_the_program_back():
    from sela_tpu_torch.codec import encoder

    sound = encoder.encode_wav
    for cell in CELLS:
        with controlled(cell):
            assert encoder.encode_wav is not sound
    assert encoder.encode_wav is sound


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    out = harness.run_cell(cell, 3, 0.3, False, time.perf_counter(),
                           device="cpu", sizes=SMALL)
    assert out["correct"], out["checks"]
