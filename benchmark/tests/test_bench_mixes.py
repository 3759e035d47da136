"""Each mix builds its requests from the seed: the same seed gives the
same requests, another seed other audio over the same notes."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark import harness
from benchmark.gen.music import make_track, recipe
from benchmark.traffic import Traffic
from conftest import CELLS, SMALL

SEED = (1 << 31) + 977   # seeds reach past 32 signed bits


def _traffic(cell: str, seed: int) -> Traffic:
    spec = harness.load_spec()
    _, cfg, mix = harness.load_cell(spec, cell)
    return Traffic({**cfg, **SMALL["config"]}, {**mix, **SMALL["mix"]},
                   seed, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests(cell):
    a, b, c = _traffic(cell, SEED), _traffic(cell, SEED), _traffic(cell, 5)
    assert a.start == b.start and np.array_equal(a.keep, b.keep)
    assert [a.track(i) for i in range(6)] == [b.track(i) for i in range(6)]
    for wa, wb, wc in zip(a.pool, b.pool, c.pool):
        for x, y, z in zip(wa.channels, wb.channels, wc.channels):
            np.testing.assert_array_equal(x, y)
            assert not np.array_equal(x, z)
    if a.state is not None:   # the decode ops' streams
        assert a.state == b.state
    # consecutive requests take different tracks
    assert a.track(0) != a.track(1)


def test_pool_tracks_differ():
    t = _traffic("cd16_v1.ingest", SEED)
    x, y = (w.channels[0] for w in t.pool)
    assert not np.array_equal(x, y)


def test_seed_draws_order_not_notes():
    """Every seed plays the recipe's multiset of notes in its own order."""
    notes = recipe(20.0, 44100, 7, 0)
    assert notes["lens"].sum() == 20 * 44100
    x = make_track(20.0, 44100, 16, 7, 0, 1, "cpu")
    y = make_track(20.0, 44100, 16, 7, 0, 2, "cpu")
    assert len(x[0]) == len(y[0]) == 20 * 44100
    assert not np.array_equal(x[0], y[0])
    # the level is the recipe's: the two seeds' loudness agrees closely
    rx, ry = (float(np.sqrt(np.mean(c[0].astype(np.float64) ** 2)))
              for c in (x, y))
    assert abs(rx - ry) < 0.25 * max(rx, ry)
