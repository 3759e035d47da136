"""Port FIR + Rice bit counts (K5's plain version) on the CPU against the JAX
package.

`ops.filters.fir_rice` on CPU tensors (the plain version its wrapper runs)
must equal, bit for bit, in residues, effective order and bit counts:
- the Pallas kernel `fir_rice_pallas` in interpret mode, on <=24-bit rows
  (its limb domain);
- the generic jnp `ops.filters.fir_residues` plus `ops.rice.bit_counts`,
  on full-scale int32 rows.
Rows mix orders 0..32, tails (n_valid = N, N - 37, 1, 0), rows whose
prediction blows past the |e| < 2^30 guard, and rows whose residue is
exactly -2^30, 2^30 - 1, 2^30 or -(2^30 - 1) (c = 0, so e = x). Every
comparison is exact: the stage is normative integer code.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.kernels.encode import fir_rice_pallas
from sela_tpu.ops import filters as jax_filters
from sela_tpu.ops import rice as jax_rice
from sela_tpu_torch.format import MAX_ORDER
from sela_tpu_torch.ops import coeffs as port_coeffs
from sela_tpu_torch.ops import filters as port_filters

_jax_fir = jax.jit(jax_filters.fir_residues)
_jax_counts = jax.jit(lambda e: jax_rice.bit_counts(jax_rice.zigzag(e)))


def _coeffs(rng, order: np.ndarray):
    """Random q in [-64, 63] -> Q20 coefficients by the integer Levinson."""
    q = rng.integers(-64, 64, (len(order), MAX_ORDER)).astype(np.int32)
    c = port_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                         torch.from_numpy(order))
    return c.numpy()


def _port(x, c, order, nv):
    e, eff, counts = port_filters.fir_rice(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in (x, c, order, nv)])
    return e.numpy(), eff.numpy(), counts.numpy()


def test_fir_rice_plain_matches_pallas_interpret(rng, signal_factory):
    """<= 24-bit rows: the Pallas kernel's limb domain (|x| < 2^26)."""
    B, N = 64, 2048
    order = (np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
    kinds = ["ar", "noise", "tone", "impulse", "dc", "silence"]
    x = np.stack([signal_factory(rng, N, amp=int(2 ** rng.uniform(4, 23)),
                                 kind=kinds[r % len(kinds)])
                  for r in range(B)]).astype(np.int32)
    c = _coeffs(rng, order)
    # guard rows: saturated coefficients (|c| <= 2^23, the integer
    # Levinson's range) at order 32 under full-scale DC: a prediction near
    # 2^31 trips the guard (rows 60, 62); near 2^28 it does not (row 61)
    blow = np.zeros(B, bool)
    blow[60:63] = True
    order[blow] = MAX_ORDER
    c[60:62], c[62] = (1 << 23) - 1, -(1 << 23)
    x[60], x[61], x[62] = (1 << 23) - 1, 1 << 20, -(1 << 23)
    nv = np.full(B, N, np.int32)
    nv[[3, 40]] = N - 37
    nv[[5, 41]] = 1
    nv[[7, 42]] = 0
    x[np.arange(N)[None, :] >= nv[:, None]] = 0     # encoder rows are padded
    e, eff, counts = _port(x, c, order, nv)
    ew, effw, cw = fir_rice_pallas(jnp.asarray(x), jnp.asarray(c),
                                   jnp.asarray(order), jnp.asarray(nv),
                                   interpret=True)
    np.testing.assert_array_equal(e, np.asarray(ew))
    np.testing.assert_array_equal(eff, np.asarray(effw))
    np.testing.assert_array_equal(counts, np.asarray(cw))
    np.testing.assert_array_equal(eff[60:63], [0, MAX_ORDER, 0])


@pytest.mark.parametrize("tail", [2048, 2011, 1, 0])
def test_fir_rice_plain_matches_generic_fir_int32(rng, tail):
    """Full-scale int32 rows (32-bit PCM), orders 0..32, plus the four rows
    whose residue sits on either side of each guard edge."""
    B, N = 40, 2048
    order = (np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
    x = rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64)
    # half the rows smooth (a low-passed walk), so most of them pass
    walk = np.cumsum(rng.integers(-(1 << 20), 1 << 20, (B // 2, N)), axis=1)
    x[: B // 2] = np.clip(walk, -(1 << 31), (1 << 31) - 1)
    x = x.astype(np.int32)
    c = _coeffs(rng, order)
    edges = {36: -(1 << 30), 37: (1 << 30) - 1, 38: 1 << 30, 39: -((1 << 30) - 1)}
    for r, v in edges.items():
        x[r] = v
        c[r] = 0
        order[r] = 7
    nv = np.full(B, tail, np.int32)
    nv[::3] = N
    e, eff, counts = _port(x, c, order, nv)
    ew, effw = _jax_fir(jnp.asarray(x), jnp.asarray(c), jnp.asarray(order),
                        jnp.asarray(nv))
    np.testing.assert_array_equal(e, np.asarray(ew))
    np.testing.assert_array_equal(eff, np.asarray(effw))
    np.testing.assert_array_equal(counts, np.asarray(_jax_counts(ew)))
    # e == x on the edge rows: only -2^30 and 2^30 trip the guard, and only
    # where some sample is valid
    trips = np.array([True, False, True, False]) & (nv[36:40] > 0)
    np.testing.assert_array_equal(eff[36:40], np.where(trips, 0, 7))


def test_fir_residues_are_inverted_by_iir(rng, signal_factory):
    """On rows that pass the guard, IIR synthesis of the residues gives x."""
    B, N = 12, 300
    order = (np.arange(B) * 3 % (MAX_ORDER + 1)).astype(np.int32)
    x = np.stack([signal_factory(rng, N, kind="ar") for _ in range(B)])
    c = _coeffs(rng, order)
    nv = np.full(B, N, np.int32)
    e, eff, _ = _port(x, c, order, nv)
    assert (eff == order).all()
    back = port_filters.iir_synthesize_reference(torch.from_numpy(e),
                                                 torch.from_numpy(c))
    np.testing.assert_array_equal(back.numpy(), x)


def test_fir_rice_rejects_bad_inputs():
    x = torch.zeros((4, 64), dtype=torch.int32)
    c = torch.zeros((4, MAX_ORDER), dtype=torch.int32)
    o = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_filters.fir_rice(x.long(), c, o, o)
    with pytest.raises(ValueError):
        port_filters.fir_rice(x, c[:, :8].contiguous(), o, o)
    with pytest.raises(ValueError):
        port_filters.fir_rice(x, c, o[:3], o)
    with pytest.raises(ValueError):
        port_filters.fir_rice(torch.zeros((4, 4096), dtype=torch.int32), c, o, o)
    with pytest.raises(ValueError):
        port_filters.fir_rice(torch.zeros((64, 4), dtype=torch.int32).t(),
                              c, o, o)
