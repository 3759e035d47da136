"""Port Rice planning (K6's plain version) on the CPU against the JAX package.

The port's zigzag, bit counts, shift sums, k selection and plan_blocks must
equal, bit for bit: sela_tpu.ops.rice, the Pallas kernel `ksel_pallas` in
interpret mode, and the numpy oracle's optimal_k. Rows cover random music
-like values, empty rows, all-zero rows and INT32_MIN rows (which force the
verbatim escape), with k_max in {30, 7, 0}. Every comparison is exact: the
stage is normative integer code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.kernels.encode import ksel_pallas
from sela_tpu.ops import i64
from sela_tpu.ops import rice as jax_rice
from sela_tpu.ref import rice as ref_rice
from sela_tpu_torch.ops import rice as port_rice

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
N = 256


def _blocks(seed: int, B: int = 96):
    """[B, N] int32 value blocks and their valid counts: Laplacian values of
    many scales, empty and all-zero rows, a row holding INT32_MIN, a row of
    INT32_MIN only, a row of +-INT32_MAX, and assorted tails."""
    rng = np.random.default_rng(seed)
    scale = 2.0 ** rng.uniform(0, 24, B)
    v = np.round(rng.laplace(0, 1, (B, N)) * scale[:, None])
    v = np.clip(v, I32_MIN, I32_MAX).astype(np.int32)
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[:8] = N
    nv[8] = 0                       # empty
    v[9] = 0                        # all zero
    v[10, 5] = I32_MIN
    v[11] = I32_MIN                 # escape-forcing: every code is 2^32 - 1
    v[12] = np.where(np.arange(N) % 2, I32_MAX, -I32_MAX)
    nv[13:16] = (1, 2, N - 1)
    return v, nv


def _masked(v, nv):
    return np.where(np.arange(v.shape[1])[None, :] < nv[:, None], v, 0)


def test_zigzag_matches_jax():
    v, _ = _blocks(0)
    v[0, :6] = (0, -1, 1, I32_MIN, I32_MAX, -I32_MAX)
    got = port_rice.zigzag(torch.from_numpy(v))
    assert got.dtype == torch.int64
    want = np.asarray(jax_rice.zigzag(jnp.asarray(v))).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) == (1 << 32) - 1


def test_bit_counts_matches_jax():
    v, nv = _blocks(1)
    vm = _masked(v, nv)
    got = port_rice.bit_counts(port_rice.zigzag(torch.from_numpy(vm)))
    assert got.dtype == torch.int32 and got.shape == (len(v), 32)
    want = np.asarray(jax_rice.bit_counts(jax_rice.zigzag(jnp.asarray(vm))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_shift_sums_match_jax(k_max):
    v, nv = _blocks(2)
    counts = np.array(jax_rice.bit_counts(jax_rice.zigzag(
        jnp.asarray(_masked(v, nv)))))
    got = port_rice.shift_sums_from_counts(torch.from_numpy(counts), k_max)
    want = i64.to_py(jax_rice._shift_sums_from_counts(jnp.asarray(counts),
                                                      k_max))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_ksel_plain_matches_jax_and_pallas(k_max):
    v, nv = _blocks(3 + k_max)
    counts = port_rice.bit_counts(port_rice.zigzag(
        torch.from_numpy(_masked(v, nv))))
    k, bits = port_rice.ksel(counts, torch.from_numpy(nv), k_max)
    kr, br = port_rice.k_and_bits_reference(counts, torch.from_numpy(nv), k_max)
    assert torch.equal(k, kr) and torch.equal(bits, br)
    assert k.dtype == bits.dtype == torch.int32
    cj, nj = jnp.asarray(counts.numpy()), jnp.asarray(nv)
    kw, bw = jax_rice.k_and_bits_from_counts(cj, nj, k_max)
    np.testing.assert_array_equal(k.numpy(), np.asarray(kw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bw))
    kp, bp = ksel_pallas(cj, nj, k_max, interpret=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(kp))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bp))
    # the escape and the empty row are where expected
    assert int(k[11]) == 31 and int(bits[11]) == 32 * nv[11]
    assert int(k[8]) == 0 and int(bits[8]) == 0


@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_ksel_random_counts_match_jax(k_max):
    """Counts not derived from values: any counts <= n <= 65535."""
    rng = np.random.default_rng(100 + k_max)
    B = 128
    n = rng.integers(0, 65536, B).astype(np.int32)
    n[:4] = (0, 1, 65535, 2)
    frac = rng.random((B, 32)) ** rng.uniform(0.2, 6, (B, 1))
    counts = np.floor(frac * n[:, None]).astype(np.int32)
    counts[4] = n[4]                 # every bit set: escape
    k, bits = port_rice.ksel(torch.from_numpy(counts), torch.from_numpy(n),
                             k_max)
    kw, bw = jax_rice.k_and_bits_from_counts(jnp.asarray(counts),
                                             jnp.asarray(n), k_max)
    np.testing.assert_array_equal(k.numpy(), np.asarray(kw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bw))


@pytest.mark.parametrize("k_max", [30, 7])
def test_plan_blocks_matches_jax_and_oracle(k_max):
    v, nv = _blocks(7)
    k, bits, nw = port_rice.plan_blocks(torch.from_numpy(v),
                                        torch.from_numpy(nv), k_max)
    kw, bw, nww = jax_rice.plan_blocks(jnp.asarray(v), jnp.asarray(nv), k_max)
    np.testing.assert_array_equal(k.numpy(), np.asarray(kw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bw))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(nww))
    for r in range(len(v)):
        if nv[r]:
            u = ref_rice.zigzag(v[r, : nv[r]])
            assert int(k[r]) == ref_rice.optimal_k(u, k_max), r
    np.testing.assert_array_equal(port_rice.block_words(bits).numpy(),
                                  (bits.numpy() + 31) // 32)


def test_ksel_rejects_bad_inputs():
    c = torch.zeros((4, 32), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_rice.ksel(c.long(), n)
    with pytest.raises(ValueError):
        port_rice.ksel(c[:, :31], n)
    with pytest.raises(ValueError):
        port_rice.ksel(c, n[:3])
    with pytest.raises(ValueError):
        port_rice.ksel(c, n, 31)
    with pytest.raises(ValueError):
        port_rice.ksel(torch.zeros((32, 4), dtype=torch.int32).t(), n)
