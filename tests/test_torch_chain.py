"""K9, the roofline tool's int32 chain (tools/roofline.py::chain_kernel),
on the CPU: the port's plain version (ops/chain.py::int_chain_reference)
against a literal T-step loop and against the JAX tool's Pallas probe run
in interpret mode, exactly; and the wrapper's refusals. The kernel itself
(csrc/int_chain.cu) is held to the plain version on the card in
tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sela_tpu_torch.ops.chain import int_chain, int_chain_reference

A, B = 1103515245, 12345


def _inputs(rows: int, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, (rows, 128), dtype=np.int64).astype(np.int32)
    x[0, :2] = (-(1 << 31), (1 << 31) - 1)
    return x


def _loop(x: np.ndarray, steps: int) -> np.ndarray:
    y = x.view(np.uint32).copy()
    for _ in range(steps):
        y = y * np.uint32(A) + np.uint32(B)
    return y.view(np.int32)


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 1000])
def test_reference_matches_a_literal_loop(steps):
    x = _inputs(8, steps)
    got = int_chain_reference(torch.from_numpy(x), steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _loop(x, steps))


def test_reference_matches_the_pallas_probe_in_interpret_mode():
    """The JAX tool's chain_kernel (make_probe is nested in vpu_microbench,
    so the six lines are rebuilt here with its VMEM specs), run through
    pl.pallas_call in interpret mode at [8, 128], T = 1,000."""
    steps = 1000

    def chain_kernel(x_ref, o_ref):
        a = jnp.int32(A)
        b = jnp.int32(B)

        def step(i, y):
            return y * a + b

        o_ref[:, :] = jax.lax.fori_loop(0, steps, step, x_ref[:, :])

    x = _inputs(8, 7)
    want = pl.pallas_call(
        chain_kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x))
    got = int_chain_reference(torch.from_numpy(x), steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


REFUSALS = {
    "cpu tensor": (lambda: torch.zeros((8, 128), dtype=torch.int32), 10,
                   ValueError, "CUDA"),
    "int64": (lambda: torch.zeros((8, 128), dtype=torch.int64), 10, TypeError,
              "int32"),
    "last dim 64": (lambda: torch.zeros((8, 64), dtype=torch.int32), 10,
                    ValueError, "128"),
    "1-D": (lambda: torch.zeros(128, dtype=torch.int32), 10, ValueError, "128"),
    "negative T": (lambda: torch.zeros((8, 128), dtype=torch.int32), -1,
                   ValueError, "steps"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    """The wrapper launches the kernel or raises: it refuses a CPU tensor
    (there is no fallback to the plain version) and bad inputs."""
    make, steps, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        int_chain(make(), steps)
