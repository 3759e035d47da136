"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card: it carries the `cuda` marker and skips on
a host without one. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets JAX up.) Comparisons of the
normative integer kernels (K1, K2/K7, K5, K6, K8) are exact. K3 is held to
|r - r_plain| <= 1e-5 r[0] a row (its sums run in another order than
torch's); K4, given the same r, to identical order and q and a cost within
one float32 rounding, since it runs the plain version's IEEE operations in
the same order.
"""
import numpy as np
import pytest
import torch

from sela_tpu_torch.format import MAX_ORDER
from sela_tpu_torch.kernels import coeffs as k_lpc
from sela_tpu_torch.kernels import encode as k_enc
from sela_tpu_torch.kernels import iir as k_iir
from sela_tpu_torch.ops import analysis as ops_analysis
from sela_tpu_torch.ops import coeffs as ops_coeffs
from sela_tpu_torch.ops import filters as ops_filters
from sela_tpu_torch.ops import rice as ops_rice
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


LPC_CASES = [pytest.param(b, None, id=str(b)) for b in (1, 77, 1024, 7752)] + [
    pytest.param(77, q, id=f"77-q{q}-order32") for q in (-64, 63)]


@pytest.mark.parametrize("B,q_edge", LPC_CASES)
def test_lpc_kernel_matches_plain(dev, B, q_edge):
    q, order = _plan(np.random.default_rng(B), B)
    if q_edge is not None:   # the extreme reflections at full order
        q[:], order[:] = q_edge, MAX_ORDER
    q, order = q.to(dev), order.to(dev)
    before = k_lpc.launches
    got = ops_coeffs.lpc_from_q(q, order)
    assert k_lpc.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ops_coeffs.lpc_from_q_reference(q, order))


@pytest.mark.parametrize("B,N", [(1, 1), (77, 2048), (300, 100), (1024, 2048),
                                 (77, 31), (77, 32), (77, 33)])
@pytest.mark.parametrize("wrap", [False, True])
def test_iir_kernel_matches_plain(dev, B, N, wrap):
    rng = np.random.default_rng(B + N)
    q, order = _plan(rng, B)
    c = ops_coeffs.lpc_from_q_reference(q, order)
    # rows whose only coefficient is c_32: the history reaches a whole tile
    # of 32 samples back
    c[1::8] = 0
    c[1::8, MAX_ORDER - 1] = torch.from_numpy(
        rng.integers(-(1 << 23), (1 << 23) + 1, len(c[1::8])).astype(np.int32))
    c = c.to(dev)
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


def _audio(rng, B: int, N: int, bits: int = 16) -> np.ndarray:
    """[B, N] int32 rows of AR(2) audio at assorted levels, a few of them
    silent, DC or full-scale noise."""
    e = rng.normal(0, 1, (B, N))
    x = np.zeros((B, N))
    a1 = rng.uniform(0.5, 1.9, B)
    for n in range(N):
        x[:, n] = e[:, n] + (a1 * x[:, n - 1] - 0.9 * x[:, n - 2] if n > 1 else 0)
    lim = (1 << (bits - 1)) - 1
    x *= (lim * 10.0 ** rng.uniform(-3, -0.3, B))[:, None] / np.maximum(
        np.abs(x).max(axis=1, keepdims=True), 1e-9)
    x[16::17] = 0
    x[5::23] = lim // 3
    x[9::29] = rng.integers(-lim, lim, (len(x[9::29]), N))
    return np.clip(np.round(x), -lim - 1, lim).astype(np.int32)


def _ids(grid):
    return [f"B{b}-N{n}" for b, n in grid]


GRID = [(b, n) for b in (1, 77, 2048) for n in (1, 100, 2048)]
# K3's edges: 1,027 rows at lengths on its tilings' edges (a lane's 16
# samples, a pass's 512; N % 4 != 0 takes the scalar staging path)
AC_EDGES = [(1027, n) for n in (1, 31, 32, 33, 255, 256, 257, 2047)]


@pytest.mark.parametrize("B,N", GRID + AC_EDGES, ids=_ids(GRID + AC_EDGES))
def test_autocorr_kernel_matches_plain(dev, B, N):
    rng = np.random.default_rng(B * 7 + N)
    x = _audio(rng, B, N, bits=24)
    if (B, N) in AC_EDGES:   # all-zero, INT32_MIN and +-(2^24 - 1) rows
        x[0::7] = 0
        x[1::7] = -(1 << 31)
        x[2::7] = (1 << 24) - 1
        x[3::7, ::2], x[3::7, 1::2] = (1 << 24) - 1, -((1 << 24) - 1)
    x = torch.from_numpy(x).to(dev)
    before = k_enc.launches["autocorr"]
    got = ops_analysis.autocorr(x)
    assert k_enc.launches["autocorr"] == before + 1
    want = ops_analysis.autocorr_reference(x)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs().max(dim=1).values
    assert bool((err <= 1e-5 * want[:, 0].double()).all()), err.max().item()


@pytest.mark.parametrize("B", [1, 77, 2048])
@pytest.mark.parametrize("max_order", [32, 8])
def test_levinson_kernel_matches_plain_given_r(dev, B, max_order):
    rng = np.random.default_rng(B + max_order)
    x = torch.from_numpy(_audio(rng, B, 2048)).to(dev)
    r = ops_analysis.autocorr_reference(x)
    r[::13] = 0.0                                   # invalid rows
    nv = torch.from_numpy(rng.integers(0, 2049, B).astype(np.int32)).to(dev)
    before = k_enc.launches["levinson"]
    order, q, cost = ops_analysis.analyze_from_r(r, nv, max_order)
    assert k_enc.launches["levinson"] == before + 1
    wo, wq, wc = ops_analysis.analyze_from_r_reference(r, nv, max_order)
    torch.cuda.synchronize()
    assert torch.equal(order, wo) and torch.equal(q, wq)
    assert torch.allclose(cost, wc, rtol=1.2e-7, atol=0.0)


@pytest.mark.parametrize("B,N", GRID, ids=_ids(GRID))
def test_fir_rice_kernel_matches_plain(dev, B, N):
    rng = np.random.default_rng(B * 3 + N)
    bits = 32 if B == 77 else 16
    x = _audio(rng, B, N, bits=bits)
    order = rng.permutation(np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
    q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
    c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                        torch.from_numpy(order))
    if B > 4:   # rows whose residue is exactly on a guard edge (c = 0)
        c[:4] = 0
        x[:4] = np.array([-(1 << 30), (1 << 30) - 1, 1 << 30, -(1 << 30) + 1],
                         np.int32)[:, None]
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[: B // 2] = N
    args = [torch.from_numpy(a).to(dev) for a in (x, c.numpy(), order, nv)]
    before = k_enc.launches["fir_rice"]
    got = ops_filters.fir_rice(*args)
    assert k_enc.launches["fir_rice"] == before + 1
    want = ops_filters.fir_rice_reference(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B", [1, 77, 2048])
@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_ksel_kernel_matches_plain(dev, B, k_max):
    rng = np.random.default_rng(B + k_max)
    n = rng.integers(0, 65536, B).astype(np.int32)
    frac = rng.random((B, 32)) ** rng.uniform(0.2, 6, (B, 1))
    counts = np.floor(frac * n[:, None]).astype(np.int32)
    counts[::11] = n[::11, None]                    # every bit set: escape
    n[::7] = 0
    counts[::7] = 0
    ct, nt = torch.from_numpy(counts).to(dev), torch.from_numpy(n).to(dev)
    before = k_enc.launches["ksel"]
    got = ops_rice.ksel(ct, nt, k_max)
    assert k_enc.launches["ksel"] == before + 1
    want = ops_rice.k_and_bits_reference(ct, nt, k_max)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


GRID8 = [(b, n) for b in (1, 77, 1024) for n in (1, 100, 2048)]
# K8's edges: 1,027 rows, n_valid on the quarters' and the lanes' edges,
# rows whose widest zigzag code has 1, 31 and 32 bits (and the residue
# that has it)
QC_WIDTHS = {1: -1, 31: -(1 << 30), 32: -(1 << 31)}
QC_CASES = [pytest.param(b, n, None, id=f"B{b}-N{n}") for b, n in GRID8] + [
    pytest.param(1027, 2048, w, id=f"B1027-N2048-width{w}") for w in QC_WIDTHS]


@pytest.mark.parametrize("B,N,width", QC_CASES)
def test_quarter_counts_kernel_matches_plain(dev, B, N, width):
    rng = np.random.default_rng(B * 5 + N + (width or 0))
    e = rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64)
    if width is None:
        e[::2] >>= rng.integers(0, 31, (len(e[::2]), 1))    # narrower rows
        e = e.astype(np.int32)
        e[::9] = -(1 << 31)                                  # every bit set
        e[0, :2] = (-(1 << 31), (1 << 31) - 1)[:N]
        nv = rng.integers(0, N + 1, B).astype(np.int32)
        edges = np.minimum(np.array([0, 1, 2, 3, 4, 5, 6, 7, N]), N)
        nv[: min(B, len(edges))] = edges[: min(B, len(edges))]
    else:
        widest = QC_WIDTHS[width]
        e = np.clip(e, widest, -widest - 1).astype(np.int32)
        e[::3, 5] = widest
        nv = np.resize(np.array([1, 3, 4, 5, 127, 128, 129, 2047, 2048, 0],
                                np.int32), B)
    et, nt = torch.from_numpy(e).to(dev), torch.from_numpy(nv).to(dev)
    before = k_enc.launches["quarter_counts"]
    got = ops_rice.quarter_counts(et, nt)
    assert k_enc.launches["quarter_counts"] == before + 1
    want = ops_rice.quarter_counts_reference(et, nt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_encode_kernel_wrappers_check_cuda_inputs(dev):
    x = torch.zeros((4, 4096), dtype=torch.int32, device=dev)
    c = torch.zeros((4, MAX_ORDER), dtype=torch.int32, device=dev)
    o = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        ops_filters.fir_rice(x, c, o, o)
    with pytest.raises(ValueError):
        ops_analysis.autocorr(x)
    with pytest.raises(ValueError):
        ops_rice.ksel(c, o.cpu())
    with pytest.raises(TypeError):
        ops_analysis.analyze_from_r(c.float()[:, :33].contiguous(), o.long())
    with pytest.raises(TypeError):
        ops_rice.quarter_counts(x.long(), o)
    with pytest.raises(ValueError):
        ops_rice.quarter_counts(x.t(), torch.zeros(4096, dtype=torch.int32,
                                                   device=dev))
    with pytest.raises(ValueError):
        ops_rice.quarter_counts(x, o.cpu())
    with pytest.raises(ValueError):   # rows over 2,048 samples
        ops_rice.quarter_counts(x, o)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_encode_on_card_gives_input_back(dev, bits):
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(bits)
    n = 2048 * 5 + 17
    rows = _audio(rng, 2, n, bits=bits)
    chans = [rows[0], (0.7 * rows[0] + 0.3 * rows[1]).astype(np.int32)]
    if bits == 32:
        chans[0][3], chans[1][4] = -(1 << 31), (1 << 31) - 1
    w = WavData(48000, bits, chans)
    for name in k_enc.launches:
        k_enc.launches[name] = 0
    buf = encode_wav(w, chunk_frames=2, device="cuda")
    # the default profile runs every encode kernel but K8
    assert all(v > 0 for k, v in k_enc.launches.items()
               if k != "quarter_counts"), k_enc.launches
    assert k_enc.launches["quarter_counts"] == 0
    # the card's K3 rounds its sums in another order than the CPU's, so
    # the streams may part on near-tied orders: sizes stay within 0.5%
    cpu = encode_wav(w, chunk_frames=2, device="cpu")
    assert abs(len(buf) - len(cpu)) <= 0.005 * len(cpu)
    for out in (decode_sela(buf, device="cuda"), ref_codec.decode_sela(buf)):
        for a, b in zip(out.channels, chans):
            np.testing.assert_array_equal(a, b)


def test_v2_encode_on_card_gives_input_back(dev):
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(4)
    n = 2048 * 5 + 17
    env = np.exp(-(np.arange(n) % 5292) / 660.0)       # a hit every 0.12 s
    hits = env * 24000 * np.sin(0.0256 * np.arange(n))
    chans = [np.clip(np.round(hits * g + rng.normal(0, 120, n) * (0.15 + env)),
                     -32768, 32767).astype(np.int32) for g in (1.0, 0.9)]
    w = WavData(44100, 16, chans)
    for name in k_enc.launches:
        k_enc.launches[name] = 0
    buf = encode_wav(w, chunk_frames=2, device="cuda",
                     profile=BitstreamProfile(residue_partition=4))
    assert all(v > 0 for v in k_enc.launches.values()), k_enc.launches
    assert k_enc.launches["quarter_counts"] == k_enc.launches["ksel"] == 3
    for out in (decode_sela(buf, device="cuda"), ref_codec.decode_sela(buf)):
        for a, b in zip(out.channels, chans):
            np.testing.assert_array_equal(a, b)
