"""The port's Rice packers against the JAX package's and the oracle's.

ops/pack.py's plain version (the CPU side of the device packer's wrapper)
against sela_tpu.ops.pack.pack_blocks_reference_shapes and ref.rice.encode
on the cases of tests/test_device_pack.py, exactly; the wrapper's refusals;
utils/bitpack.py's list API against the JAX package's utils.bitpack.
"""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from sela_tpu.ops.pack import pack_blocks_reference_shapes  # noqa: E402
from sela_tpu.ref import rice as jax_rice  # noqa: E402
from sela_tpu.utils import bitpack as jax_bitpack  # noqa: E402
from sela_tpu_torch.ops import pack as ops_pack  # noqa: E402
from sela_tpu_torch.ref import rice as ref_rice  # noqa: E402
from sela_tpu_torch.utils import bitpack  # noqa: E402


def _check(vals, ks, n_valid, max_words):
    """The port's words and counts equal the JAX function's and, up to
    max_words, the oracle's; words past a row's count are zero."""
    got_w, got_n = ops_pack.pack_blocks(
        torch.from_numpy(vals), torch.from_numpy(ks), torch.from_numpy(n_valid),
        max_words)
    got_w = got_w.numpy().view(np.uint32)
    got_n = got_n.numpy()
    jw, jn = pack_blocks_reference_shapes(
        jnp.asarray(vals), jnp.asarray(ks), jnp.asarray(n_valid), max_words)
    np.testing.assert_array_equal(got_w, np.asarray(jw))
    np.testing.assert_array_equal(got_n, np.asarray(jn))
    for b in range(vals.shape[0]):
        _, want = ref_rice.encode(vals[b, : n_valid[b]], int(ks[b]))
        assert got_n[b] == len(want), b
        m = min(max_words, len(want))
        np.testing.assert_array_equal(got_w[b, :m], want[:m], err_msg=f"{b}")
        assert not got_w[b, m:].any(), b


def test_pack_matches_jax_and_oracle_optimal_k(rng):
    B, N = 24, 512
    vals = np.round(rng.laplace(0, 300, (B, N))).astype(np.int32)
    n_valid = np.full(B, N, np.int32)
    n_valid[3], n_valid[7], n_valid[11] = 50, 1, 0
    # values past n_valid are left in place: the wrapper masks them
    ks = np.array(
        [ref_rice.optimal_k(ref_rice.zigzag(vals[b, : n_valid[b]]))
         for b in range(B)], np.int32)
    _check(vals, ks, n_valid, N)


@pytest.mark.parametrize("kfix", [0, 1, 5, 13, 30])
def test_pack_matches_jax_and_oracle_forced_k(rng, kfix):
    amp = 1 << min(kfix + 3, 30)
    vals = rng.integers(-amp, amp, (6, 96)).astype(np.int32)
    _check(vals, np.full(6, kfix, np.int32), np.full(6, 96, np.int32), 2048)


def test_pack_matches_jax_and_oracle_word_boundary_patterns():
    # k = 30 packs 31-bit patterns that almost always straddle two words
    vals = np.array([[(1 << 30) - 1, -(1 << 30), 1, 0, -1, 7] * 8], np.int32)
    _check(vals, np.array([30], np.int32), np.array([48], np.int32), 128)


def test_pack_rows_over_max_words_keep_their_first_words(rng):
    """A row whose words exceed max_words keeps its first max_words words
    and reports its true word count, as the JAX function does."""
    vals = np.round(rng.laplace(0, 3000, (5, 2048))).astype(np.int32)
    ks = np.array([0, 3, 9, 11, 30], np.int32)
    n_valid = np.array([2048, 2048, 1000, 7, 2048], np.int32)
    _check(vals, ks, n_valid, 40)


def test_pack_wrapper_refuses_bad_inputs():
    v = torch.zeros((4, 64), dtype=torch.int32)
    k = torch.zeros(4, dtype=torch.int32)
    for bad_k in (31, 32, -1):   # the escape, the partition marker
        with pytest.raises(ValueError, match="plain blocks"):
            ops_pack.pack_blocks(v, torch.full_like(k, bad_k), k, 8)
    with pytest.raises(TypeError):
        ops_pack.pack_blocks(v.long(), k, k, 8)
    with pytest.raises(TypeError):
        ops_pack.pack_blocks(v, k.long(), k, 8)
    with pytest.raises(ValueError):          # [B, N] with N <= 2,048
        ops_pack.pack_blocks(torch.zeros((4, 4096), dtype=torch.int32), k, k, 8)
    with pytest.raises(ValueError):
        ops_pack.pack_blocks(v, k[:3], k, 8)
    with pytest.raises(ValueError):
        ops_pack.pack_blocks(torch.zeros((64, 4), dtype=torch.int32).t(), k, k,
                             8)
    with pytest.raises(ValueError):
        ops_pack.pack_blocks(v, k, k, 0)
    with pytest.raises(ValueError):          # one device
        ops_pack.pack_blocks(v, k.to("meta"), k, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        ops_pack.pack_blocks(v.to("meta"), k.to("meta"), k.to("meta"), 8)


def test_bitpack_matches_jax_bitpack(rng):
    """The list API, plain and partitioned blocks (sub-ks, escapes and
    empty blocks among them), against the JAX package's."""
    blocks = []
    for i in range(12):
        n = int(rng.integers(0, 600)) if i % 5 else 0
        v = np.round(rng.laplace(0, 10.0 ** rng.uniform(0, 5), n)).astype(
            np.int32)
        if i % 3 == 0:
            ks, _ = jax_rice.encode_partitioned(v)
            blocks.append((v, list(ks)))
        elif i % 3 == 1:
            blocks.append((v, jax_rice.optimal_k(jax_rice.zigzag(v))))
        else:
            blocks.append((v, 31))
    got = bitpack.pack_blocks(blocks)
    want = jax_bitpack.pack_blocks(blocks)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    unblocks = [(w, len(v), k) for w, (v, k) in zip(got, blocks)]
    for g, w, (v, _) in zip(bitpack.unpack_blocks(unblocks),
                            jax_bitpack.unpack_blocks(unblocks), blocks):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, v)
    assert bitpack.pack_blocks([]) == [] and bitpack.unpack_blocks([]) == []
