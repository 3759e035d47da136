"""Port float analysis (K3's and K4's plain versions) on the CPU against the
JAX package's Pallas kernels in interpret mode.

Float analysis is non-normative (FORMAT.md "Design invariant"), so these
comparisons carry tolerances, each with its reason:
- K3, `autocorr`: |r - r_pallas| <= 1e-5 r[0] on every row. Both sum 2,048
  float32 products, in different orders (torch's reduction against XLA's);
  the rounding of such a sum stays orders of magnitude below 1e-5 of r[0],
  which bounds every |r[lag]|.
- K4, `analyze_from_r` given the SAME r as `_levinson_tiles`: order and q
  identical, and the modeled cost within 5e-4 n_valid bits (1 bit for a
  2,048-sample row). Both run K4's float32 operations in K4's order, and
  the port rounds every one of them; XLA:CPU may contract a product and a
  sum into one FMA (as in e (1 - k k)), and the two logarithms may differ
  in the last place. On strongly predictable rows |k| nears 1, 1 - k k
  cancels, and err then differs by up to ~1e-4 relative (measured: 0.2
  bits at most on a 2,048-sample row over 768 rows). That can flip an
  order only on a near-tie, so the test allows at most 1 row in 500 to
  differ in order or q; none has so far.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.kernels.encode import LANES_LEV, _levinson_tiles, autocorr_pallas
from sela_tpu.ref import lpc as ref_lpc
from sela_tpu_torch.format import MAX_ORDER
from sela_tpu_torch.ops import analysis as port_analysis

N = 2048


def _rows(rng, signal_factory, B: int, scale_bits=(6, 23)):
    """B rows of assorted content: AR, tones, noise, impulse, DC, silence,
    at levels between 2^6 and 2^23, some with a zero-padded tail."""
    kinds = ["ar", "tone", "noise", "impulse", "dc", "silence", "ar", "ar"]
    x = np.stack([signal_factory(rng, N, amp=int(2 ** rng.uniform(*scale_bits)),
                                 kind=kinds[r % len(kinds)]) for r in range(B)])
    nv = np.full(B, N, np.int32)
    nv[1::5] = rng.integers(1, N, len(nv[1::5]))
    x[np.arange(N)[None, :] >= nv[:, None]] = 0
    return x.astype(np.int32), nv


def test_autocorr_plain_matches_pallas_interpret(rng, signal_factory):
    x, _ = _rows(rng, signal_factory, 64)
    x[60] = rng.integers(-(1 << 31), 1 << 31, N, dtype=np.int64)  # 32-bit
    got = port_analysis.autocorr(torch.from_numpy(x)).numpy()
    want = np.asarray(autocorr_pallas(jnp.asarray(x), interpret=True))
    assert got.shape == (64, MAX_ORDER + 1) and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want).max(axis=1)
    assert (err <= 1e-5 * want[:, 0]).all(), err / np.maximum(want[:, 0], 1e-30)
    # and against the float64 oracle on the same scale
    want64 = np.stack([ref_lpc.autocorr(r.astype(np.float64) / 32768.0, MAX_ORDER)
                       for r in x])
    assert (np.abs(got - want64).max(axis=1) <= 1e-5 * want64[:, 0]).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 255, 256, 257, 2047])
def test_autocorr_plain_matches_pallas_interpret_at_edges(rng, signal_factory,
                                                          n):
    """Rows as long as the CUDA kernel's tiling edges (a lane's 16 samples,
    a pass's 512, groups of 4), with all-zero, INT32_MIN and +-(2^24 - 1)
    rows; below 33 samples some lags have no product at all."""
    x, _ = _rows(rng, signal_factory, 40)
    x = np.ascontiguousarray(x[:, :n])
    x[0::7] = 0
    x[1::7] = -(1 << 31)
    x[2::7] = (1 << 24) - 1
    x[3::7, ::2], x[3::7, 1::2] = (1 << 24) - 1, -((1 << 24) - 1)
    got = port_analysis.autocorr(torch.from_numpy(x)).numpy()
    want = np.asarray(autocorr_pallas(jnp.asarray(x), interpret=True))
    assert got.shape == (40, MAX_ORDER + 1)
    err = np.abs(got.astype(np.float64) - want).max(axis=1)
    assert (err <= 1e-5 * want[:, 0]).all(), err / np.maximum(want[:, 0], 1e-30)
    assert not got[0::7].any() and not got[:, n:].any()   # no products there


@functools.lru_cache(maxsize=None)
def _levinson_jax(max_order: int):
    return functools.partial(_levinson_tiles, max_order=max_order,
                             interpret=True)


def _pallas_analyze_from_r(r: np.ndarray, nv: np.ndarray, max_order: int):
    B = len(r)
    pad = (-B) % LANES_LEV
    rt = jnp.asarray(np.pad(r, ((0, pad), (0, 0))).T)
    nvt = jnp.asarray(np.pad(nv, (0, pad))[None, :])
    o, qt, cost = _levinson_jax(max_order)(rt, nvt)
    return (np.asarray(o)[0, :B], np.asarray(qt).T[:B],
            np.asarray(cost)[0, :B])


@pytest.mark.parametrize("max_order", [32, 12, 1])
def test_levinson_plain_matches_pallas_interpret_given_r(rng, signal_factory,
                                                         max_order):
    x, nv = _rows(rng, signal_factory, 128)
    r = np.array(autocorr_pallas(jnp.asarray(x), interpret=True))
    r[7] = 0.0                                # r0 = 0: an invalid row
    r[9, 0] = -1.0                            # r0 < 0: invalid too
    order, q, cost = port_analysis.analyze_from_r(
        torch.from_numpy(r), torch.from_numpy(nv), max_order)
    assert order.dtype == q.dtype == torch.int32 and cost.dtype == torch.float32
    ow, qw, cw = _pallas_analyze_from_r(r, nv, max_order)
    differ = (order.numpy() != ow) | (q.numpy() != qw).any(axis=1)
    assert differ.sum() <= len(r) // 500, np.flatnonzero(differ)
    assert (np.abs(cost.numpy() - cw) <= 5e-4 * nv).all()
    assert int(order.max()) <= max_order
    assert order[7] == 0 and order[9] == 0 and not q[[7, 9]].any()
    # q is zero from the order on and inside the 7-bit range below it
    cols = np.arange(MAX_ORDER)[None, :]
    qn = q.numpy()
    assert not qn[cols >= order.numpy()[:, None]].any()
    assert qn.min() >= -64 and qn.max() <= 63


def test_analyze_is_autocorr_then_levinson(rng, signal_factory):
    x, nv = _rows(rng, signal_factory, 24)
    xt, nvt = torch.from_numpy(x), torch.from_numpy(nv)
    got = port_analysis.analyze(xt, nvt, 20)
    want = port_analysis.analyze_from_r_reference(
        port_analysis.autocorr_reference(xt), nvt, 20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the chosen order models the stream well: on AR(2) rows it is >= 2
    assert (got[0].numpy()[[0, 6, 7]] >= 2).all()


def test_analysis_wrappers_reject_bad_inputs():
    x = torch.zeros((4, 64), dtype=torch.int32)
    r = torch.zeros((4, MAX_ORDER + 1), dtype=torch.float32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_analysis.autocorr(x.float())
    with pytest.raises(ValueError):
        port_analysis.autocorr(torch.zeros((2, 4096), dtype=torch.int32))
    with pytest.raises(TypeError):
        port_analysis.analyze_from_r(r.double(), n)
    with pytest.raises(ValueError):
        port_analysis.analyze_from_r(r[:, :32].contiguous(), n)
    with pytest.raises(ValueError):
        port_analysis.analyze_from_r(r, n, 0)
    with pytest.raises(ValueError):
        port_analysis.analyze_from_r(r, n[:2])
