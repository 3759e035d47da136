"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card: it carries the `cuda` marker and skips on
a host without one. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets JAX up.) Comparisons are
exact, as every stage is normative integer code.
"""
import numpy as np
import pytest
import torch

from sela_tpu_torch.format import MAX_ORDER
from sela_tpu_torch.kernels import coeffs as k_lpc
from sela_tpu_torch.kernels import iir as k_iir
from sela_tpu_torch.ops import coeffs as ops_coeffs
from sela_tpu_torch.ops.filters import iir_synthesize_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _plan(rng, B: int):
    order = rng.permutation(np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
    q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
    return torch.from_numpy(q), torch.from_numpy(order)


@pytest.mark.parametrize("B", [1, 77, 1024, 7752])
def test_lpc_kernel_matches_plain(dev, B):
    q, order = _plan(np.random.default_rng(B), B)
    q, order = q.to(dev), order.to(dev)
    before = k_lpc.launches
    got = ops_coeffs.lpc_from_q(q, order)
    assert k_lpc.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ops_coeffs.lpc_from_q_reference(q, order))


@pytest.mark.parametrize("B,N", [(1, 1), (77, 2048), (300, 100), (1024, 2048)])
@pytest.mark.parametrize("wrap", [False, True])
def test_iir_kernel_matches_plain(dev, B, N, wrap):
    rng = np.random.default_rng(B + N)
    q, order = _plan(rng, B)
    c = ops_coeffs.lpc_from_q_reference(q, order).to(dev)
    lim = 1 << 31 if wrap else 1 << 12
    e = torch.from_numpy(rng.integers(-lim, lim, (B, N), dtype=np.int64)
                         .astype(np.int32)).to(dev)
    before = k_iir.launches
    got = k_iir.iir_synthesize(e, c)
    assert k_iir.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, iir_synthesize_reference(e, c))


def test_kernel_wrappers_check_cuda_inputs(dev):
    e = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    c = torch.zeros((4, MAX_ORDER), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        k_iir.iir_synthesize(e.long(), c)
    with pytest.raises(ValueError):
        k_iir.iir_synthesize(e, c.cpu())
    with pytest.raises(ValueError):
        ops_coeffs.lpc_from_q(
            torch.zeros((MAX_ORDER, 4), dtype=torch.int32, device=dev).t(),
            e[:, 0].contiguous())


def test_decode_on_card_gives_input_back(dev):
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(5)
    n = 2048 * 5 + 17
    t = np.arange(n)
    left = np.round(12000 * np.sin(0.02 * t) + rng.normal(0, 30, n))
    right = 0.7 * left + rng.normal(0, 30, n)
    chans = [np.clip(x, -32768, 32767).astype(np.int32) for x in (left, right)]
    buf = ref_codec.encode_wav(WavData(44100, 16, chans))
    got = decode_sela(buf, chunk_frames=2, device="cuda")
    for a, b in zip(got.channels, chans):
        np.testing.assert_array_equal(a, b)
