"""Port `encode_step(device="cpu")` against the JAX `encode_step(fused=True)`
with its Pallas kernels in interpret mode — the path the JAX package runs on
a TPU, and the one the port's kernels replace.

Cases cover C = 1..4 channels, the est and exact mid/side rules, and 16,
24 and 32-bit PCM (32-bit without mid/side, as FORMAT.md requires), with a
tail frame. Every output array must be identical: the render is normative,
and the analysis (K3 + K4) gives the same orders and coefficients here (its
tolerances are in tests/test_torch_analysis.py). Each distinct shape and
rule costs one interpret-mode compile of the JAX step (~45 s on a CPU), so
the cases share shapes: 16 and 24-bit data run through one compile.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.codec.pipeline import encode_step as jax_encode_step
from sela_tpu_torch.codec.pipeline import encode_step

F, S = 2, 2048
KEYS = ("residues", "res16", "fits16", "order", "qcoeffs", "k_res", "k_res4",
        "k_coeff", "nw_res", "nw_coeff", "sftype")


def _chunk(C: int, bits: int, seed: int):
    """[F, C, S] PCM: a tone at a level per channel over noise that the
    channels share (so mid/side pays) plus a little of their own, the last
    frame cut to a tail of 1,501 samples (zero-padded)."""
    rng = np.random.default_rng(seed)
    n = F * S
    t = np.arange(n)
    amp = 0.7 * ((1 << (bits - 1)) - 1)
    base = np.sin(2 * np.pi * 440 * t / 48000) * np.exp(-t / n)
    shared = rng.normal(0, 0.02, n)
    x = np.zeros((C, n))
    for c in range(C):
        x[c] = amp * ((0.8 - 0.15 * c) * base + shared
                      + rng.normal(0, 10.0 ** -rng.uniform(3, 5), n))
    x = np.clip(np.round(x), -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
    x = x.astype(np.int64).astype(np.int32).reshape(C, F, S).transpose(1, 0, 2)
    x = np.ascontiguousarray(x)
    nv = np.array([S, 1501], np.int32)
    x[-1, :, nv[-1]:] = 0
    return x, nv


@pytest.mark.parametrize("C,ms_mode,bits", [
    (2, "est", 16), (2, "est", 24),        # the main path
    (3, "exact", 16), (3, "exact", 24),    # a pair and a lone channel
    (4, "est", 16), (4, "est", 24),        # two pairs
    (1, "est", 32),                        # 32-bit: direct subframes only
])
def test_encode_step_matches_jax_fused(C, ms_mode, bits):
    x, nv = _chunk(C, bits, seed=C * 100 + bits)
    allow_ms = bits <= 24
    want = jax_encode_step(jnp.asarray(x), jnp.asarray(nv), allow_ms=allow_ms,
                           fused=True, ms_mode=ms_mode)
    got = encode_step(torch.from_numpy(x), torch.from_numpy(nv),
                      allow_ms=allow_ms, ms_mode=ms_mode)
    assert set(got) == set(KEYS)
    for key in KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    if C >= 2 and allow_ms:   # both rules ran, as the case meant
        assert (got["sftype"].numpy() != 0).any()
