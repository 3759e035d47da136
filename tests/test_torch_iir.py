"""Port IIR synthesis (K2/K7 counterpart) on the CPU against the JAX package.

The port's plain `iir_synthesize_reference` (what its wrapper runs for CPU
tensors) must equal, bit for bit, the JAX scan path and both Pallas kernels
in interpret mode: the limb kernel (fast=True) on <=24-bit data and the
generic kernel (fast=False) on uniform random int32 residues, whose
synthesis wraps mod 2^32. Exact comparisons throughout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.format import MAX_ORDER
from sela_tpu.kernels.iir import iir_synthesize_pallas
from sela_tpu.ops import coeffs as jax_coeffs
from sela_tpu.ops import filters as jax_filters
from sela_tpu.ref import lpc as ref_lpc
from sela_tpu_torch.kernels import iir as port_iir
from sela_tpu_torch.ops import coeffs as port_coeffs
from sela_tpu_torch.ops.filters import iir_synthesize_reference

_scan = jax.jit(jax_filters.iir_synthesize)
_fir = jax.jit(jax_filters.fir_residues)
_jnp_lpc = jax.jit(lambda q, o: jax_coeffs.reflection_to_lpc(
    jax_coeffs.dequantize_reflection(q), o))


def _coeffs(rng, order: np.ndarray) -> np.ndarray:
    q = rng.integers(-64, 64, (len(order), MAX_ORDER)).astype(np.int32)
    q[np.arange(MAX_ORDER)[None, :] >= order[:, None]] = 0
    return np.asarray(_jnp_lpc(jnp.asarray(q), jnp.asarray(order)))


def _plain(e: np.ndarray, c: np.ndarray) -> np.ndarray:
    return port_iir.iir_synthesize(torch.tensor(e), torch.tensor(c)).numpy()


@pytest.mark.parametrize("amp", [1 << 15, 1 << 23])
def test_iir_plain_matches_scan_and_fast_kernel(amp):
    """<=24-bit domain, mixed orders in one tile, B not a multiple of 128:
    residues from the JAX FIR of a bounded signal, so the synthesis must
    also give the signal back."""
    rng = np.random.default_rng(amp)
    B, N = 13, 256
    order = np.array([0, 1, 2, 8, 9, 16, 17, 31, 32, 5, 30, 32, 3], np.int32)
    c = _coeffs(rng, order)
    x = rng.integers(-amp, amp, (B, N)).astype(np.int32)
    e, eff = _fir(jnp.asarray(x), jnp.asarray(c), jnp.asarray(order),
                  jnp.asarray(np.full(B, N, np.int32)))
    # rows the residue guard dropped to order 0 carry x verbatim
    c = np.where(np.asarray(eff)[:, None] > 0, c, 0).astype(np.int32)
    e = np.asarray(e)
    got = _plain(e, c)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, np.asarray(_scan(e, c)))
    np.testing.assert_array_equal(
        got, np.asarray(iir_synthesize_pallas(e, c, interpret=True, fast=True)))


def test_iir_plain_wraps_like_generic_kernel():
    """Uniform int32 residues under valid coefficients: x wraps mod 2^32 and
    the history keeps the wrapped values (the K7 contract)."""
    rng = np.random.default_rng(7)
    B, N = 7, 192
    order = np.array([32, 1, 17, 0, 32, 8, 25], np.int32)
    c = _coeffs(rng, order)
    e = rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64).astype(np.int32)
    got = _plain(e, c)
    np.testing.assert_array_equal(got, np.asarray(_scan(e, c)))
    np.testing.assert_array_equal(
        got, np.asarray(iir_synthesize_pallas(e, c, interpret=True, fast=False)))


def test_iir_plain_matches_oracle_on_rendered_rows():
    """Oracle render (FIR + residue guard) then the port's synthesis gives the
    oracle's own synthesis and the signal back, order by order."""
    rng = np.random.default_rng(11)
    N = 300
    t = np.arange(N)
    es, cs, xs = [], [], []
    for order in range(0, MAX_ORDER + 1, 4):
        x = np.round(9000 * np.sin(0.05 * t * (1 + order / 8))
                     + rng.normal(0, 40, N)).astype(np.int32)
        gamma, _ = ref_lpc.levinson_reflection(ref_lpc.autocorr(x))
        o, q, e = ref_lpc.render_channel(x, order,
                                         ref_lpc.quantize_reflection(gamma))
        c = np.zeros(MAX_ORDER, np.int32)
        c[:o] = ref_lpc.reflection_to_lpc(ref_lpc.dequantize_reflection(q))
        np.testing.assert_array_equal(ref_lpc.reconstruct_channel(e, o, q), x)
        es.append(e), cs.append(c), xs.append(x)
    got = _plain(np.stack(es), np.stack(cs))
    np.testing.assert_array_equal(got, np.stack(xs))


def test_iir_wrapper_dispatches_cpu_and_checks():
    e = torch.zeros((3, 64), dtype=torch.int32)
    c = torch.zeros((3, MAX_ORDER), dtype=torch.int32)
    before = port_iir.launches
    assert torch.equal(port_iir.iir_synthesize(e, c), e)
    assert port_iir.launches == before      # the plain version is no launch
    with pytest.raises(TypeError):
        port_iir.iir_synthesize(e.long(), c)
    with pytest.raises(ValueError):
        port_iir.iir_synthesize(e, c[:2])
    with pytest.raises(ValueError):
        port_iir.iir_synthesize(e[:, ::2], c)
    with pytest.raises(ValueError):
        port_iir.iir_synthesize(e.to("meta"), c.to("meta"))


def test_iir_plain_order_zero_is_identity():
    e = torch.from_numpy(
        np.random.default_rng(3).integers(-2**31, 2**31, (4, 50),
                                          dtype=np.int64).astype(np.int32))
    c = torch.zeros((4, MAX_ORDER), dtype=torch.int32)
    assert torch.equal(iir_synthesize_reference(e, c), e)
    assert port_coeffs.lpc_from_q(torch.zeros((4, MAX_ORDER), dtype=torch.int32),
                                  torch.zeros(4, dtype=torch.int32)).abs().sum() == 0
