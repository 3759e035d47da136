"""The port's frame-axis sharding (sela_tpu_torch/parallel/mesh.py) on a mesh
of 8 CPU devices, against its own unsharded steps and the JAX package's
sharded steps on the 8-virtual-device CPU mesh (tests/conftest.py).

Every comparison is exact (tolerance 0): the render and the synthesis are
normative, and the port's analysis plans each frame alone, so sharding
changes no output.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from sela_tpu import parallel as jax_parallel
from sela_tpu_torch.codec.pipeline import encode_step
from sela_tpu_torch.parallel import mesh

CPU8 = ["cpu"] * 8
RENDER_KEYS = ("residues", "order", "k_res", "k_res4", "k_coeff", "nw_res",
               "nw_coeff")


def _valid(x, n_valid):
    return np.arange(x.shape[-1])[None, None, :] < n_valid[:, None, None]


def test_data_mesh_over_listed_devices():
    m = mesh.data_mesh(devices=CPU8)
    assert m.size == 8 and m.shape == {"data": 8}
    assert all(d == torch.device("cpu") for d in m.devices)
    assert mesh.data_mesh(3, devices=CPU8).size == 3
    with pytest.raises(ValueError, match="n_devices"):
        mesh.data_mesh(9, devices=CPU8)


@pytest.mark.parametrize("F,multiple", [(5, 8), (8, 8), (1, 1), (13, 4),
                                        (16, 3), (0, 2)])
def test_pad_frames_to_multiple_matches_jax(F, multiple):
    rng = np.random.default_rng(F * 10 + multiple)
    x = rng.integers(-99, 99, (F, 2, 16)).astype(np.int32)
    nv = rng.integers(1, 17, F).astype(np.int32)
    got = mesh.pad_frames_to_multiple(x, nv, multiple)
    want = jax_parallel.pad_frames_to_multiple(x, nv, multiple)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] % multiple == 0


def test_sharded_codec_step_exact_and_matches_jax():
    x, n_valid = ge._example_batch(F=16, C=2, S=512)
    pcm, exact = mesh.sharded_codec_step(mesh.data_mesh(devices=CPU8))(
        x, n_valid)
    assert exact.shape == (16,) and bool(exact.all())
    valid = _valid(x, n_valid)
    np.testing.assert_array_equal(np.where(valid, pcm.numpy(), 0),
                                  np.where(valid, x, 0))
    jpcm, jexact = jax_parallel.sharded_codec_step(jax_parallel.data_mesh())(
        x, n_valid)
    assert bool(np.asarray(jexact).all())
    np.testing.assert_array_equal(np.where(valid, pcm.numpy(), 0),
                                  np.where(valid, np.asarray(jpcm), 0))


@pytest.mark.parametrize("partition", [1, 4])
@pytest.mark.parametrize("F", [16, 13])
def test_sharded_encode_step_matches_unsharded(partition, F):
    x, n_valid = ge._example_batch(F=F, C=2, S=512, seed=3)
    got = mesh.sharded_encode_step(mesh.data_mesh(devices=CPU8),
                                   partition=partition)(x, n_valid)
    want = encode_step(torch.from_numpy(x), torch.from_numpy(n_valid),
                       partition=partition)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)


def test_device_steps_split_a_shard_without_changing_it(monkeypatch):
    """A shard past MAX_STEP_ELEMENTS runs as several steps on its device:
    the same outputs as one step."""
    x, n_valid = ge._example_batch(F=13, C=2, S=512, seed=5)
    m = mesh.data_mesh(devices=["cpu"] * 2)
    want = mesh.sharded_encode_step(m, partition=4)(x, n_valid)
    wpcm, _ = mesh.sharded_codec_step(m)(x, n_valid)
    monkeypatch.setattr(mesh, "MAX_STEP_ELEMENTS", 3 * 4 * 512)   # 3 frames
    got = mesh.sharded_encode_step(m, partition=4)(x, n_valid)
    pcm, exact = mesh.sharded_codec_step(m)(x, n_valid)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)
    assert torch.equal(pcm, wpcm) and bool(exact.all())


def test_sharded_decode_step_of_jax_plans():
    """The JAX encode's plan arrays, decoded by the port over 3 shards (one
    padded): the input PCM on every valid sample."""
    from sela_tpu.codec.pipeline import encode_step as jax_encode_step

    x, n_valid = ge._example_batch(F=7, C=2, S=512, seed=4)
    enc = jax_encode_step(jnp.asarray(x), jnp.asarray(n_valid))
    pcm = mesh.sharded_decode_step(mesh.data_mesh(devices=["cpu"] * 3))(
        *(np.array(enc[k]) for k in ("res16", "qcoeffs", "order", "sftype")))
    valid = _valid(x, n_valid)
    assert pcm.shape == x.shape and pcm.dtype == torch.int32
    np.testing.assert_array_equal(np.where(valid, pcm.numpy(), 0),
                                  np.where(valid, x, 0))


def test_port_render_of_jax_sharded_planning():
    """Given the JAX sharded encode's (qcoeffs, order, sftype) under
    partition=4, the port's integer render reproduces JAX's residues and
    Rice planning exactly."""
    x, n_valid = ge._example_batch(F=16, C=2, S=512, seed=7)
    jenc = jax_parallel.sharded_encode_step(jax_parallel.data_mesh(),
                                            partition=4)(x, n_valid)
    enc = {k: torch.from_numpy(np.array(jenc[k]))
           for k in ("qcoeffs", "order", "sftype")}
    assert (enc["sftype"] != 0).any()   # mid/side rows are re-rendered too
    got = mesh.rerender(x, n_valid, enc)
    for key in RENDER_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(jenc[key]),
                                      err_msg=key)


def test_dryrun_multichip_on_8_cpu_devices():
    x, n_valid = ge._example_batch(F=32, C=2, S=2048)
    enc = mesh.dryrun_multichip(mesh.data_mesh(devices=CPU8), x, n_valid)
    assert enc["residues"].shape == x.shape
