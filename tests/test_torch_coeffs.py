"""Port K1 (dequantize + integer Levinson) on the CPU against the JAX package.

The port's plain `lpc_from_q` (the version its wrapper runs for CPU tensors)
must equal, bit for bit: the jnp pair `dequantize_reflection` +
`reflection_to_lpc`, the Pallas kernel `lpc_from_q_pallas` in interpret mode,
and the numpy oracle `ref.lpc`. Every comparison is exact: the stage is
normative integer code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.format import MAX_ORDER
from sela_tpu.kernels.coeffs import lpc_from_q_pallas
from sela_tpu.ops import coeffs as jax_coeffs
from sela_tpu.ref import lpc as ref_lpc
from sela_tpu_torch.ops import coeffs as port_coeffs

_jnp_lpc = jax.jit(lambda q, o: jax_coeffs.reflection_to_lpc(
    jax_coeffs.dequantize_reflection(q), o))


def _plan(seed: int, B: int = 77):
    """B rows, orders 0..32 cycling, every q in [-64, 63] present."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
    q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
    q.reshape(-1)[:128] = np.arange(-64, 64)
    return q, order


def _port(q: np.ndarray, order: np.ndarray) -> np.ndarray:
    return port_coeffs.lpc_from_q(torch.from_numpy(q),
                                  torch.from_numpy(order)).numpy()


def _oracle(q: np.ndarray, order: np.ndarray) -> np.ndarray:
    out = np.zeros((len(order), MAX_ORDER), np.int32)
    for r, o in enumerate(order):
        out[r, :o] = ref_lpc.reflection_to_lpc(
            ref_lpc.dequantize_reflection(q[r, :o]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lpc_plain_matches_jnp_and_oracle(seed):
    q, order = _plan(seed)
    got = _port(q, order)
    np.testing.assert_array_equal(
        got, np.asarray(_jnp_lpc(jnp.asarray(q), jnp.asarray(order))))
    np.testing.assert_array_equal(got, _oracle(q, order))
    # the port's two normative halves on their own give the same
    g = port_coeffs.dequantize_reflection(torch.from_numpy(q))
    np.testing.assert_array_equal(
        port_coeffs.reflection_to_lpc(g, torch.from_numpy(order)).numpy(), got)


def test_lpc_plain_matches_pallas_interpret():
    """One interpret-mode call (it is slow on the CPU) covers valid rows and
    hostile ones. Out-of-range q (only a crafted stream can carry one, and
    the decoder rejects it at unpack) still gives the Pallas kernel's exact
    result: the int32 dequantize wraps the same way and |g| is clamped to
    2^20."""
    q, order = _plan(3)
    rng = np.random.default_rng(4)
    q_bad = rng.integers(-2**31, 2**31 - 1, (8, MAX_ORDER)).astype(np.int32)
    q = np.concatenate([q, q_bad])
    order = np.concatenate([order, np.full(8, MAX_ORDER, np.int32)])
    want = np.asarray(lpc_from_q_pallas(jnp.asarray(q), jnp.asarray(order),
                                        interpret=True))
    got = _port(q, order)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got[-8:].astype(np.int64)).max() <= 1 << 23


@pytest.mark.parametrize("val", [-64, 63])
def test_lpc_plain_extreme_q_full_order(val):
    """Extreme valid q at full order drives the SAT clamp at every step."""
    q = np.full((4, MAX_ORDER), val, np.int32)
    order = np.full(4, MAX_ORDER, np.int32)
    got = _port(q, order)
    np.testing.assert_array_equal(
        got, np.asarray(_jnp_lpc(jnp.asarray(q), jnp.asarray(order))))
    np.testing.assert_array_equal(got, _oracle(q, order))


def test_lpc_wrapper_rejects_bad_inputs():
    q = torch.zeros((5, MAX_ORDER), dtype=torch.int32)
    o = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_coeffs.lpc_from_q(q.long(), o)
    with pytest.raises(TypeError):
        port_coeffs.lpc_from_q(q, o.long())
    with pytest.raises(ValueError):
        port_coeffs.lpc_from_q(q[:, :16], o)
    with pytest.raises(ValueError):
        port_coeffs.lpc_from_q(q, o[:4])
    with pytest.raises(ValueError):
        port_coeffs.lpc_from_q(torch.zeros((MAX_ORDER, 5), dtype=torch.int32).t(), o)
    with pytest.raises(ValueError):
        port_coeffs.lpc_from_q(q.to("meta"), o.to("meta"))
