"""Port Rice planning (K6's plain version) on the CPU against the JAX package.

The port's zigzag, bit counts, shift sums, k selection and plan_blocks must
equal, bit for bit: sela_tpu.ops.rice, the Pallas kernel `ksel_pallas` in
interpret mode, and the numpy oracle's optimal_k. Rows cover random music
-like values, empty rows, all-zero rows and INT32_MIN rows (which force the
verbatim escape), with k_max in {30, 7, 0}. The render's planning
(`rice_plan_reference`, K6's render entry's plain version) is held to the
JAX package's: plan_blocks for the coefficient block,
k_and_bits_from_counts for the residue block and, under partitioned
residues, ksel_pallas in interpret mode on the quarters and the JAX
render's decision. Every comparison is exact: the stage is normative
integer code.
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


# ------------------------------------------- the render's planning (K6) --

PLAN_B, PLAN_N = 1027, 2048
NV_EDGES = (0, 3, 4, 5, PLAN_N - 1, PLAN_N)
EFF_EDGES = (0, 1, 31, 32)


def _plan_inputs(seed: int):
    """The render's planning inputs at [1,027] rows: residues whose scale
    changes from quarter to quarter (so both the plain and the partitioned
    form win somewhere) and rows of INT32_MIN residues (every code 2^32 - 1:
    counts = n in every column, the escape); n_valid 0, 3, 4, 5, 2,047 and
    2,048 on every other row; eff_order 0, 1, 31 and 32 on four rows of
    five; q in [-64, 63] with rows of -64, 63, INT32_MIN, INT32_MAX and both
    extremes. Returns numpy (counts_res, quarter_counts, q, eff_order,
    n_valid)."""
    rng = np.random.default_rng(seed)
    B, N = PLAN_B, PLAN_N
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[::2] = np.resize(np.array(NV_EDGES, np.int32), len(nv[::2]))
    scale = 2.0 ** rng.uniform(0, 16, (B, 4))
    e = rng.laplace(0, 1, (B, N)) * np.repeat(scale, N // 4, axis=1)
    e = np.clip(np.round(e), I32_MIN, I32_MAX).astype(np.int32)
    e[5::11] = I32_MIN
    et, nvt = torch.from_numpy(e), torch.from_numpy(nv)
    counts = port_rice.bit_counts(port_rice.zigzag(
        torch.from_numpy(_masked(e, nv)))).numpy()
    qc = port_rice.quarter_counts_reference(et, nvt).numpy()
    eff = rng.integers(0, 33, B).astype(np.int32)
    for i, v in enumerate(EFF_EDGES):
        eff[i::5] = v
    q = rng.integers(-64, 64, (B, 32)).astype(np.int32)
    q[0::9], q[1::9], q[2::9], q[3::9] = -64, 63, I32_MIN, I32_MAX
    q[4::9] = np.where(np.arange(32) % 2, I32_MIN, I32_MAX)
    return counts, qc, q, eff, nv


def _jax_plan(counts, qc, q, eff, nv, k_max: int, partition: bool) -> dict:
    """The JAX package's planning of the same rows: plan_blocks for the
    coefficient block, k_and_bits_from_counts for the residue block and,
    under partitioned residues, ksel_pallas (interpret mode) on the quarters
    and the JAX _render_rows' decision (sela_tpu/codec/pipeline.py:138-158)."""
    from sela_tpu.format import RICE_PARTITION_MARKER

    nvj, effj = jnp.asarray(nv), jnp.asarray(eff)
    q_eff = jnp.where(jnp.arange(32)[None, :] < effj[:, None], jnp.asarray(q), 0)
    k_coeff, _, nw_coeff = jax_rice.plan_blocks(q_eff, effj, k_max)
    k_res, bits_res = jax_rice.k_and_bits_from_counts(jnp.asarray(counts), nvj,
                                                      k_max)
    nw_res = jax_rice.block_words(bits_res)
    kr4 = extra = jnp.zeros_like(effj)
    if partition:
        cols = jnp.arange(4, dtype=jnp.int32)[None, :]
        lo, hi = (cols * nvj[:, None]) // 4, ((cols + 1) * nvj[:, None]) // 4
        kq, bq = ksel_pallas(jnp.asarray(qc).reshape(-1, 32),
                             (hi - lo).reshape(-1), k_max, interpret=True)
        kq = kq.reshape(-1, 4)
        nw_part = jax_rice.block_words(bq.reshape(-1, 4).sum(axis=1))
        use_part = (nvj >= 4) & (32 * nw_part + 8 * 4 < 32 * nw_res)
        packed = kq[:, 0] | (kq[:, 1] << 8) | (kq[:, 2] << 16) | (kq[:, 3] << 24)
        kr4 = jnp.where(use_part, packed, 0)
        k_res = jnp.where(use_part, RICE_PARTITION_MARKER, k_res)
        nw_res = jnp.where(use_part, nw_part, nw_res)
        extra = jnp.where(use_part, 8 * 4, 0)
    out = dict(q_eff=q_eff, k_res=k_res, kr4=kr4, k_coeff=k_coeff,
               nw_res=nw_res, nw_coeff=nw_coeff,
               block_bits=32 * (nw_res + nw_coeff) + extra)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("partition", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_rice_plan_plain_matches_jax_planning(k_max, partition):
    """rice_plan_reference (and the wrapper on the CPU) equals the JAX
    package's planning of the render, bit for bit, at 1,027 rows holding
    every edge of _plan_inputs."""
    counts, qc, q, eff, nv = _plan_inputs(11 + k_max)
    args = [torch.from_numpy(a) for a in (counts, q, eff, nv)]
    qct = torch.from_numpy(qc) if partition else None
    got = port_rice.rice_plan_reference(*args, k_max, qct)
    want = _jax_plan(counts, qc, q, eff, nv, k_max, partition)
    assert set(got) == set(want) == {"q_eff", *port_rice.PLAN_KEYS}
    for key, w in want.items():
        assert got[key].dtype == torch.int32, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    wrapped = port_rice.rice_plan(*args, k_max, qct)
    assert all(torch.equal(wrapped[k], got[k]) for k in got)
    # the edges are where expected: empty blocks, escapes (INT32_MIN
    # residues escape in every quarter too, so those rows stay plain),
    # partitioned rows under v2 only
    k_res = got["k_res"].numpy()
    assert (k_res[nv == 0] == 0).all() and (got["nw_res"].numpy()[nv == 0] == 0).all()
    assert (k_res[(np.arange(PLAN_B) % 11 == 5) & (nv > 0)] == 31).all()
    assert ((got["k_coeff"].numpy() == 31) & (eff > 0)).any()
    n_part = int((k_res == 32).sum())
    assert 0 < n_part < PLAN_B if partition else n_part == 0


def test_rice_plan_rejects_bad_inputs():
    c = torch.zeros((4, 32), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    qc = torch.zeros((4, 4, 32), dtype=torch.int32)
    with pytest.raises(TypeError):
        port_rice.rice_plan(c.long(), c, n, n)
    with pytest.raises(TypeError):
        port_rice.rice_plan(c, c, n, n, 30, qc.long())
    with pytest.raises(ValueError):
        port_rice.rice_plan(c[:, :31].contiguous(), c, n, n)
    with pytest.raises(ValueError):
        port_rice.rice_plan(c, c, n[:3], n)
    with pytest.raises(ValueError):
        port_rice.rice_plan(c, c, n, n, 30, qc[:, :3].contiguous())
    with pytest.raises(ValueError):
        port_rice.rice_plan(c, torch.zeros((32, 4), dtype=torch.int32).t(), n, n)
    for k_max in (-1, 31):
        with pytest.raises(ValueError):
            port_rice.rice_plan(c, c, n, n, k_max)
    with pytest.raises(ValueError):   # two devices
        port_rice.rice_plan(c, c.to("meta"), n, n)
    with pytest.raises(ValueError):   # neither the CPU nor CUDA
        port_rice.rice_plan(*(t.to("meta") for t in (c, c, n, n)))
