"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card: it carries the `cuda` marker and skips on
a host without one. The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest` because tests/conftest.py sets JAX up.) Comparisons of the
normative integer kernels (K1, K2/K7, K5, K6 and its render entry, K8) are
exact. K3 is held to |r - r_plain| <= 1e-5 r[0] a row (its sums run in
another order than torch's); K4, given the same r, to identical order and q
and a cost within one float32 rounding, since it runs the plain version's
IEEE operations in the same order.
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


# K4's edges: 1,027 rows (not a multiple of a block's rows) with r = 0,
# r0 = 0 and r0 < 0 rows under other lags and n_valid 0, at max_order 1, 8
# and 32
LEV_CASES = [pytest.param(b, mo, False, id=f"{mo}-{b}")
             for mo in (32, 8) for b in (1, 77, 2048)] + [
    pytest.param(1027, mo, True, id=f"{mo}-1027-edges") for mo in (1, 8, 32)]


@pytest.mark.parametrize("B,max_order,edges", LEV_CASES)
def test_levinson_kernel_matches_plain_given_r(dev, B, max_order, edges):
    rng = np.random.default_rng(B + max_order)
    x = torch.from_numpy(_audio(rng, B, 2048)).to(dev)
    r = ops_analysis.autocorr_reference(x)
    r[::13] = 0.0                                   # invalid rows
    nv = torch.from_numpy(rng.integers(0, 2049, B).astype(np.int32)).to(dev)
    if edges:
        r[1::13, 0] = 0.0
        r[2::13, 0] = -r[2::13, 0].abs() - 1.0
        nv[3::13] = 0
    before = k_enc.launches["levinson"]
    order, q, cost = ops_analysis.analyze_from_r(r, nv, max_order)
    assert k_enc.launches["levinson"] == before + 1
    wo, wq, wc = ops_analysis.analyze_from_r_reference(r, nv, max_order)
    torch.cuda.synchronize()
    assert torch.equal(order, wo) and torch.equal(q, wq)
    assert torch.allclose(cost, wc, rtol=1.2e-7, atol=0.0)


def _fir_edge_rows(rng, B: int, N: int):
    """K5's edge rows: orders on every tap tier's edges (0, 8, 16, 24, 32
    and one past each), every 11th row +-2^23 on each tap up to its order,
    16-bit, 8-bit and full-scale int32 noise, smooth int32 walks and rows
    alternating INT32_MIN and INT32_MAX (the sums of the full-scale rows
    leave the FP64 path's domain), n_valid N, 0, 1 and between with nonzero
    samples past it, and rows 0-3 on both guard edges (c = 0: -2^30 and
    2^30 trip, 2^30 - 1 and -(2^30 - 1) pass)."""
    order = np.resize(np.array([0, 1, 8, 9, 16, 17, 24, 25, 32], np.int32), B)
    q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
    c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                        torch.from_numpy(order)).numpy()
    big = np.arange(B) % 11 == 3
    c[big] = (1 << 23) * rng.choice([-1, 1], (int(big.sum()), MAX_ORDER)) * (
        np.arange(MAX_ORDER)[None, :] < order[big, None])
    kind = np.arange(B) % 5
    lim = np.where(kind == 0, 1 << 15, np.where(kind == 1, 1 << 8, 1 << 31))
    x = (rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64)
         * lim[:, None]) >> 31
    walk = np.cumsum(rng.integers(-(1 << 16), 1 << 16, (B, N)), axis=1)
    x[kind == 3] = np.clip(walk[kind == 3] * 1024, -(1 << 31), (1 << 31) - 1)
    x[kind == 4] = np.where(np.arange(N) % 2 == 0, -(1 << 31), (1 << 31) - 1)
    x = x.astype(np.int32)
    c[:4], order[:4] = 0, 7
    x[:4] = np.array([-(1 << 30), (1 << 30) - 1, 1 << 30, -((1 << 30) - 1)],
                     np.int32)[:, None]
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[::4], nv[1::4], nv[2::4] = N, 0, 1
    nv[:4] = N
    return x, c, order, nv


# K5's edges: 1,027 rows at lengths on its tilings' edges (a warp's 512
# samples, a lane's 16, N % 4 != 0 takes the scalar path)
FIR_EDGES = [(1027, n) for n in (1, 31, 32, 33, 63, 64, 65, 1000, 2047)]


@pytest.mark.parametrize("B,N", GRID + FIR_EDGES, ids=_ids(GRID + FIR_EDGES))
def test_fir_rice_kernel_matches_plain(dev, B, N):
    rng = np.random.default_rng(B * 3 + N)
    if (B, N) in FIR_EDGES:
        x, c, order, nv = _fir_edge_rows(rng, B, N)
        args = [torch.from_numpy(a).to(dev) for a in (x, c, order, nv)]
    else:
        bits = 32 if B == 77 else 16
        x = _audio(rng, B, N, bits=bits)
        order = rng.permutation(np.arange(B) % (MAX_ORDER + 1)).astype(np.int32)
        q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
        c = ops_coeffs.lpc_from_q_reference(torch.from_numpy(q),
                                            torch.from_numpy(order))
        if B > 4:   # rows whose residue is exactly on a guard edge (c = 0)
            c[:4] = 0
            x[:4] = np.array([-(1 << 30), (1 << 30) - 1, 1 << 30,
                              -(1 << 30) + 1], np.int32)[:, None]
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


def _plan_rows(rng, B: int, edges: bool, dev):
    """K6's render inputs on the card (counts_res, q, eff_order, n_valid,
    quarter_counts): residues whose scale changes from quarter to quarter,
    counted by the plain versions, q in [-64, 63], eff_order 0..32, n_valid
    2,048 on most rows with tails. edges adds n_valid 0, 3, 4, 5, 2,047 and
    2,048 on every other row, eff_order 0, 1, 31 and 32 on four rows of
    five, q rows of -64, 63, INT32_MIN, INT32_MAX and both extremes, and
    rows of INT32_MIN residues (counts = n in every column: the escape)."""
    N = 2048
    nv = np.full(B, N, np.int32)
    nv[3::16] = rng.integers(0, N, len(nv[3::16]))
    eff = rng.integers(0, 33, B).astype(np.int32)
    q = rng.integers(-64, 64, (B, MAX_ORDER)).astype(np.int32)
    scale = 2.0 ** rng.uniform(0, 14, (B, 4))
    e = np.round(rng.laplace(0, 1, (B, N)) * np.repeat(scale, N // 4, axis=1))
    e = e.astype(np.int32)
    if edges:
        nv[::2] = np.resize(np.array([0, 3, 4, 5, N - 1, N], np.int32),
                            len(nv[::2]))
        for i, v in enumerate((0, 1, 31, 32)):
            eff[i::5] = v
        q[0::9], q[1::9], q[2::9], q[3::9] = -64, 63, -(1 << 31), (1 << 31) - 1
        q[4::9] = np.where(np.arange(MAX_ORDER) % 2, -(1 << 31), (1 << 31) - 1)
        e[5::11] = -(1 << 31)
    et, nvt = torch.from_numpy(e).to(dev), torch.from_numpy(nv).to(dev)
    valid = torch.arange(N, device=dev)[None, :] < nvt[:, None]
    counts = ops_rice.bit_counts(ops_rice.zigzag(torch.where(valid, et, 0)))
    qc = ops_rice.quarter_counts_reference(et, nvt)
    return (counts, torch.from_numpy(q).to(dev), torch.from_numpy(eff).to(dev),
            nvt, qc)


# K6's render entry: one row; the est rule's 1,024 winner rows and the exact
# rule's 2,048 candidate rows of a 512-frame stereo chunk; 1,027 edge rows
PLAN_CASES = [pytest.param(b, False, id=str(b)) for b in (1, 1024, 2048)] + [
    pytest.param(1027, True, id="1027-edges")]


@pytest.mark.parametrize("B,edges", PLAN_CASES)
@pytest.mark.parametrize("partition", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("k_max", [30, 7, 0])
def test_rice_plan_kernel_matches_plain(dev, B, edges, partition, k_max):
    rng = np.random.default_rng(B + 10 * k_max + partition)
    counts, q, eff, nv, qc = _plan_rows(rng, B, edges, dev)
    qc = qc if partition else None
    before = k_enc.launches["ksel"]
    got = ops_rice.rice_plan(counts, q, eff, nv, k_max, qc)
    assert k_enc.launches["ksel"] == before + 1
    want = ops_rice.rice_plan_reference(counts, q, eff, nv, k_max, qc)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("partition", [1, 4])
@pytest.mark.parametrize("ms_mode", ["est", "exact"])
def test_encode_step_plans_as_plain_on_card(dev, monkeypatch, ms_mode,
                                            partition):
    """One K6 launch plans a chunk's render, and the step's outputs equal
    those of the same step with the plain planning on the card."""
    from sela_tpu_torch.codec import pipeline

    rng = np.random.default_rng(partition)
    rows = _audio(rng, 2, 64 * 2048)
    x = torch.from_numpy(rows.reshape(2, 64, 2048).transpose(1, 0, 2)
                         .copy()).to(dev)
    nv = torch.full((64,), 2048, dtype=torch.int32, device=dev)
    nv[-1] = 1501
    kwargs = dict(ms_mode=ms_mode, partition=partition)
    before = k_enc.launches["ksel"]
    got = pipeline.encode_step(x, nv, **kwargs)
    assert k_enc.launches["ksel"] == before + 1
    monkeypatch.setattr(pipeline, "rice_plan", ops_rice.rice_plan_reference)
    want = pipeline.encode_step(x, nv, **kwargs)
    assert k_enc.launches["ksel"] == before + 1
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key


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
    with pytest.raises(ValueError):
        ops_rice.rice_plan(c, c, o, o.cpu())
    with pytest.raises(TypeError):
        ops_rice.rice_plan(c, c.long(), o, o)


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


@pytest.mark.parametrize("kind", ["8bit_3ch_fs33", "16bit_square74"])
def test_sweep_edges_encode_on_card(dev, kind):
    """chip_smoke.py's sweep contents at two of the encoder's edges: an
    8-bit 3-channel clip at frame size 33 (K3's and K5's scalar staging, a
    channel left unpaired), and a 16-bit full-scale square wave of period
    74, whose residues leave int16. Both are v1 encodes, which pack on the
    card: residues cross to the host only for escape blocks, which 16-bit
    residues at rice_k_max 30 never need, so no chunk fetches its int32
    residues. Each stream decodes exactly through the oracle and the port
    on the card, and is within 0.5% of the CPU's."""
    import chip_smoke as cs
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.metrics import Metrics

    rng = np.random.default_rng(33)
    if kind == "8bit_3ch_fs33":
        bits, fs, chans = 8, 33, cs.sweep_content("tone", 3 * 33 + 10, 3, 8,
                                                   rng)
        chans[2] = cs.sweep_content("noise", len(chans[0]), 1, 8, rng)[0]
    else:
        bits, fs, chans = 16, 2048, cs.sweep_content("square74", 4500, 2, 16,
                                                      rng)
    w = WavData(44100, bits, chans)
    for name in k_enc.launches:
        k_enc.launches[name] = 0
    before = k_lpc.launches
    m = Metrics()
    buf = encode_wav(w, frame_size=fs, chunk_frames=2, device="cuda",
                     metrics=m)
    frames = -(-len(chans[0]) // fs)
    chunks = -(-frames // 2)
    # one render a chunk: K1, K5 and K6 once, K3 and K4 once, K8 never
    assert k_lpc.launches - before == chunks
    assert {k: v for k, v in k_enc.launches.items()} == {
        "autocorr": chunks, "levinson": chunks, "fir_rice": chunks,
        "ksel": chunks, "quarter_counts": 0}, k_enc.launches
    assert m.counters.get("int32_fetch", 0) == 0
    assert m.counters["pack_blocks_device"] == 2 * frames * len(chans)
    cpu = encode_wav(w, frame_size=fs, chunk_frames=2, device="cpu")
    assert abs(len(buf) - len(cpu)) <= 0.005 * len(cpu)
    for out in (decode_sela(buf, device="cuda"), ref_codec.decode_sela(buf)):
        assert (out.sample_rate, out.bits_per_sample) == (44100, bits)
        for a, b in zip(out.channels, chans, strict=True):
            np.testing.assert_array_equal(a, b)


def _pack_rows(rng, B: int, N: int, k):
    """[B, N] int32 rows for the Rice packer at parameter k (an int, or
    None: each row at its optimal k): values within a few bits of k's range
    (full-scale int32 for k = 30), n_valid 0, 1, N and between."""
    from sela_tpu_torch.ref import rice as ref_rice

    if k is None:
        scale = 10.0 ** rng.uniform(0, 4, (B, 1))
        vals = np.round(rng.laplace(0, 1, (B, N)) * scale).astype(np.int32)
    else:
        amp = 1 << min(k + 3, 31)
        vals = rng.integers(-amp, amp, (B, N), dtype=np.int64).astype(np.int32)
    nv = rng.integers(0, N + 1, B).astype(np.int32)
    nv[::3], nv[1::5], nv[2::7] = N, 0, 1
    if k is None:
        ks = np.array([ref_rice.optimal_k(ref_rice.zigzag(vals[b, : nv[b]]))
                       for b in range(B)], np.int32)
        ks = np.minimum(ks, 30)   # an escape row is packed at k = 30 here
    else:
        ks = np.full(B, k, np.int32)
    return vals, ks, nv


PACK_KS = [None, 0, 5, 13, 30]


@pytest.mark.parametrize("B,N", GRID[:6] + [(1024, 1), (1024, 100),
                                            (1024, 2048)],
                         ids=_ids(GRID[:6] + [(1024, 1), (1024, 100),
                                              (1024, 2048)]))
@pytest.mark.parametrize("k", PACK_KS, ids=[f"k{k}" for k in PACK_KS])
def test_pack_kernel_matches_plain(dev, B, N, k):
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.native import bitio
    from sela_tpu_torch.ops.pack import pack_blocks

    rng = np.random.default_rng(B * 11 + N + (k or 31))
    vals, ks, nv = _pack_rows(rng, B, N, k)
    cpu = [torch.from_numpy(a) for a in (vals, ks, nv)]
    w_cpu, nw_cpu = pack_blocks(*cpu, 8)
    max_words = int(nw_cpu.max()) + 3        # every row fits, 3 spare words
    want = pack_blocks(*cpu, max_words)
    before = k_pack.launches
    got = pack_blocks(*[t.to(dev) for t in cpu], max_words)
    assert k_pack.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    # and the host packer's words, block by block
    words, wc = bitio.pack_blocks_flat(vals[np.arange(N)[None, :] < nv[:, None]],
                                       np.concatenate([[0], np.cumsum(nv)[:-1]]),
                                       nv, ks)
    assert np.array_equal(wc, want[1].numpy())
    dense = got[0].cpu().numpy().view(np.uint32)
    cols = np.arange(max_words)[None, :] < wc[:, None]
    assert np.array_equal(dense[cols], words)


def test_pack_kernel_rows_over_max_words_and_global_buffer(dev):
    """Rows whose words exceed max_words keep their first max_words words
    and report their true count, with the word buffer in shared memory
    (max_words <= 12,000) and in the output row (beyond); k = 30 patterns
    straddle words."""
    from sela_tpu_torch.ops.pack import pack_blocks

    rng = np.random.default_rng(3)
    vals = rng.integers(-(1 << 8), 1 << 8, (77, 2048)).astype(np.int32)
    vals[5] = np.resize(np.array([(1 << 30) - 1, -(1 << 30), 1, 0, -1, 7],
                                 np.int32), 2048)
    ks = np.zeros(77, np.int32)
    ks[5], ks[6] = 30, 3
    nv = np.full(77, 2048, np.int32)
    cpu = [torch.from_numpy(a) for a in (vals, ks, nv)]
    full = int(pack_blocks(*cpu, 8)[1].max())
    assert full > 12000
    for max_words in (100, 12000, 12001, full):
        want = pack_blocks(*cpu, max_words)
        got = pack_blocks(*[t.to(dev) for t in cpu], max_words)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0]), max_words
        assert torch.equal(got[1].cpu(), want[1]), max_words


def test_pack_wrapper_refuses_bad_inputs_on_card(dev):
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.ops.pack import pack_blocks

    v = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    k = torch.zeros(4, dtype=torch.int32, device=dev)
    before = k_pack.launches
    for bad_k in (31, 32, -1):
        with pytest.raises(ValueError, match="plain blocks"):
            pack_blocks(v, torch.full_like(k, bad_k), k, 8)
    with pytest.raises(TypeError):
        pack_blocks(v.long(), k, k, 8)
    with pytest.raises(ValueError):      # rows over 2,048 values
        pack_blocks(torch.zeros((4, 4096), dtype=torch.int32, device=dev),
                    k, k, 8)
    with pytest.raises(ValueError):
        pack_blocks(v, k.cpu(), k, 8)
    with pytest.raises(ValueError):
        pack_blocks(torch.zeros((64, 4), dtype=torch.int32, device=dev).t(),
                    k, k, 8)
    with pytest.raises(ValueError):
        pack_blocks(v, k, k, 0)
    assert k_pack.launches == before


PACK_AT_KINDS = ["optimal", "random", "full30", "escapes", "caps"]


@pytest.mark.parametrize("kind", PACK_AT_KINDS)
def test_pack_at_kernel_matches_plain(dev, kind):
    """sela_pack_at against its plain version, word for word over the
    whole flat buffer (gaps filled alike beforehand): rows at their optimal
    k, at random k, full-scale int32 at k = 30, rows at k = 31 and 32 that
    keep their gaps, and caps below, at and above the true counts, past the
    shared buffer's n + 1 words and past the end of the buffer."""
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.ops.pack import pack_blocks, pack_blocks_at

    rng = np.random.default_rng(len(kind) + 17)
    B, N = 1027, 2048
    vals, ks, nv = _pack_rows(rng, B, N, 30 if kind == "full30" else None)
    if kind == "full30":
        vals = rng.integers(-(1 << 31), 1 << 31, (B, N),
                            dtype=np.int64).astype(np.int32)
    if kind == "random":
        ks = rng.integers(0, 31, B).astype(np.int32)
    if kind == "escapes":
        ks[2::9], ks[5::13] = 31, 32
    true = pack_blocks(*(torch.from_numpy(a) for a in (vals, np.clip(
        ks, 0, 30).astype(np.int32), nv)), 1)[1].numpy()
    caps = true.astype(np.int32)
    if kind == "caps":   # short, long, over n + 1 = 2,049 words, zero
        caps[::4] = np.maximum(caps[::4] - 7, 0)
        caps[1::4] += 11
        caps[2::50] = 2049 + rng.integers(1, 3000, len(caps[2::50]))
        caps[3::40] = 0
    offs = np.concatenate([[0], np.cumsum(caps.astype(np.int64))[:-1]])
    total = int(caps.sum()) - (5 if kind == "caps" else 0)
    fill = torch.full((total,), 0x3C3C3C3C, dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (vals, ks, nv, offs, caps)]
    want = pack_blocks_at(*args, total, out=fill.clone())
    before = k_pack.launches
    got = pack_blocks_at(*[t.to(dev) for t in args], total,
                         out=fill.clone().to(dev))
    assert k_pack.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])
    plain = (ks >= 0) & (ks <= 30)
    assert np.array_equal(want[1].numpy()[plain], true[plain])
    assert (want[1].numpy()[~plain] == -1).all()


def test_pack_at_wrapper_reads_no_device_value_and_refuses(dev):
    """The wrapper refuses a mixed-device call before any launch, and on
    the card it launches without a sync (no device value is read)."""
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.ops.pack import pack_blocks_at

    v = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    k = torch.zeros(4, dtype=torch.int32, device=dev)
    offs = torch.zeros(4, dtype=torch.int64, device=dev)
    before = k_pack.launches
    with pytest.raises(ValueError):
        pack_blocks_at(v, k.cpu(), k, offs, k, 8)
    with pytest.raises(ValueError):
        pack_blocks_at(v, k, k, offs, k, 8,
                       out=torch.zeros(8, dtype=torch.int32))
    assert k_pack.launches == before
    torch.cuda.set_sync_debug_mode("error")
    try:
        pack_blocks_at(v, k, k, offs, k, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert k_pack.launches == before + 1


def _host_packed_stream(w, chunk_frames: int, profile) -> bytes:
    """encode_wav's stream with every block packed on the host: encode_step
    on the card chunk by chunk, as encode_wav runs it, then pack_frames and
    serialize_frames on its fetched outputs."""
    from sela_tpu_torch.codec import encoder
    from sela_tpu_torch.ref import container

    x, nv = encoder.frame_batches(w.channels, profile.frame_size)
    F, C, _ = x.shape
    frames = []
    for s in range(0, F, chunk_frames):
        xs, ns = x[s:s + chunk_frames], nv[s:s + chunk_frames]
        out = encoder.device_chunk(
            torch.from_numpy(np.ascontiguousarray(xs)).cuda(),
            torch.from_numpy(ns).cuda(), False, False,
            allow_ms=profile.mid_side != "off" and w.bits_per_sample <= 24,
            max_order=profile.max_order, rice_k_max=profile.rice_k_max,
            partition=profile.residue_partition,
            ms_mode="exact" if profile.mid_side == "exact" else "est")
        packed = encoder.pack_frames(out["plan"].cpu().numpy(),
                                     out["residues"].cpu().numpy(), ns)
        frames.append(encoder.serialize_frames(packed, ns, 0, len(ns)))
    return container.serialize_file(
        container.SelaHeader(w.sample_rate, w.bits_per_sample, C, F), frames)


def _device_pack_case(w, profile, chunk_frames: int = 3):
    """encode_wav on the card against _host_packed_stream: byte for byte;
    returns encode_wav's Metrics and the packer's launches."""
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    before = k_pack.launches
    buf = encode_wav(w, chunk_frames=chunk_frames, profile=profile,
                     device="cuda", metrics=m)
    launches = k_pack.launches - before
    assert buf == _host_packed_stream(w, chunk_frames, profile)
    return m, launches


def _sweep_classes():
    import chip_smoke as cs

    return [k[0] for k in cs.SWEEP_CLASSES]


@pytest.mark.parametrize("klass", _sweep_classes())
def test_v1_device_pack_equals_host_pack_over_the_sweep(dev, klass):
    """Every case of one seed of chip_smoke.py's encode sweep in a class
    (8-32 bits, 1-6 channels, frame sizes 32-2,048, every profile knob,
    rice_k_max 0 and 7 among them, whose escape blocks the host packs):
    encode_wav's stream on the card is the host packer's over the same
    encode_step outputs. v1 launches the packer twice a chunk, v2 never;
    every block is counted once, on the card or on the host."""
    import chip_smoke as cs
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref.wav import WavData

    cases = [c for c in cs.sweep_cases(cs.SWEEP_SEED) if c["klass"] == klass]
    assert cases
    for case in cases:
        profile = BitstreamProfile(frame_size=case["frame_size"],
                                   **case["profile"])
        w = WavData(case["rate"], case["bits"], case["chans"])
        m, launches = _device_pack_case(w, profile)
        F = -(-len(case["chans"][0]) // case["frame_size"])
        v1 = profile.residue_partition == 1
        assert launches == (2 * -(-F // 3) if v1 else 0), case["name"]
        blocks = 2 * F * len(case["chans"])
        assert (m.counters.get("pack_blocks_device", 0)
                + m.counters["pack_blocks_host"]) == blocks, case["name"]
        if not v1:
            assert "pack_blocks_device" not in m.counters
        if v1 and case["profile"].get("rice_k_max") == 0:
            assert m.counters["pack_blocks_host"] > 0, case["name"]


def test_v1_device_pack_on_a_cd_track(dev):
    """A 3-minute CD track (8 chunks of 512 frames): the stream is the host
    packer's, every block is packed on the card, the packer launches 16
    times, no residue crosses to the host, and neither bitio pass runs.
    Under rice_k_max=0 the host packs escape blocks."""
    import chip_smoke as cs
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref.wav import WavData

    w = WavData(44100, 16, cs.make_track(180.0, 44100, 16, seed=0))
    m, launches = _device_pack_case(w, BitstreamProfile(), chunk_frames=512)
    assert launches == 16
    assert m.counters["pack_blocks_device"] == 2 * 3876 * 2
    assert m.counters["pack_blocks_host"] == 0
    assert "int32_fetch" not in m.counters
    assert not {"rice_count", "rice_pack", "bitio_workers"} & set(m.stage_s)
    short = WavData(44100, 16, [c[:44100 * 5] for c in w.channels])
    m, launches = _device_pack_case(short, BitstreamProfile(rice_k_max=0),
                                    chunk_frames=512)
    assert launches == 2 and m.counters["pack_blocks_host"] > 0
    assert m.counters["int32_fetch"] == 1


def _composed_stream(w, profile) -> bytes:
    """encode_wav's stream as it was composed before the stream buffer,
    on the card: encode_chunks' pack_frames outputs, each chunk's frames
    as bytes (bitio.emit_frames), joined behind the header by
    serialize_file."""
    from sela_tpu_torch.codec import encoder
    from sela_tpu_torch.ref import container

    frames = []
    encoder.encode_chunks(
        [w.channels], torch.int16 if w.bits_per_sample <= 16 else torch.int32,
        profile.frame_size, torch.device("cuda"),
        encoder.DEFAULT_CHUNK_FRAMES,
        dict(allow_ms=w.bits_per_sample <= 24, max_order=profile.max_order,
             rice_k_max=profile.rice_k_max,
             partition=profile.residue_partition, ms_mode="est"), None,
        lambda start, fcount, packed, nv: frames.append(
            encoder.serialize_frames(packed, nv, 0, fcount)))
    F = -(-w.n_samples // profile.frame_size)
    return container.serialize_file(container.SelaHeader(
        w.sample_rate, w.bits_per_sample, w.n_channels, F), frames)


@pytest.mark.parametrize("track", ["cd16_v1_180s", "hires24_v2_20s"])
def test_stream_buffer_streams_are_the_composed_ones_on_card(dev, track):
    """A 3-minute CD track under v1 and a 20-s 24-bit/96 kHz track under
    v2: encode_wav, which emits into the thread's stream buffer, gives the
    composed stream byte for byte; a second encode of the track reuses the
    buffer (emit_buffer_allocs 0) and gives the same bytes."""
    import chip_smoke as cs
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.metrics import Metrics

    if track == "cd16_v1_180s":
        w = WavData(44100, 16, cs.make_track(180.0, 44100, 16, seed=0))
        profile = BitstreamProfile()
    else:
        w = WavData(96000, 24, cs.make_track(20.0, 96000, 24, seed=1))
        profile = BitstreamProfile(residue_partition=4)
    want = _composed_stream(w, profile)
    bufs, allocs = [], []
    for _ in range(2):
        m = Metrics()
        bufs.append(encode_wav(w, profile=profile, device="cuda", metrics=m))
        allocs.append(m.counters["emit_buffer_allocs"])
        assert m.stage_n["host_assemble"] == 1
    assert bufs == [want, want]
    assert allocs[1] == 0


def test_packer_launches_on_v1_encode_only(dev):
    """kernels/pack.py::launches rises by 2 a chunk on a v1 encode and by 0
    on a v2 encode and on a decode."""
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.config import BitstreamProfile
    from sela_tpu_torch.kernels import pack as k_pack
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(12)
    w = WavData(44100, 16, list(_audio(rng, 2, 2048 * 7 + 5)))
    before = k_pack.launches
    buf = encode_wav(w, chunk_frames=2, device="cuda")
    assert k_pack.launches - before == 2 * 4
    before = k_pack.launches
    encode_wav(w, chunk_frames=2, device="cuda",
               profile=BitstreamProfile(residue_partition=4))
    decode_sela(buf, device="cuda")
    assert k_pack.launches == before


def test_corpus_round_trip_on_card(dev):
    from sela_tpu_torch.codec.corpus import decode_files, encode_files
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(9)
    wavs = []
    for i, (nch, bits) in enumerate([(1, 16), (2, 16), (2, 24), (3, 16),
                                     (2, 32)]):
        n = int(rng.integers(500, 7000))
        rows = _audio(rng, nch, n, bits=bits)
        wavs.append(WavData(44100, bits, list(rows)))
    for name in k_enc.launches:
        k_enc.launches[name] = 0
    k_lpc.launches = k_iir.launches = 0
    bufs = encode_files(wavs, chunk_frames=3, device="cuda")
    outs = decode_files(bufs, chunk_frames=3, device="cuda")
    assert all(v > 0 for k, v in k_enc.launches.items()
               if k != "quarter_counts"), k_enc.launches
    assert k_lpc.launches > 0 and k_iir.launches > 0
    for w, buf, out in zip(wavs, bufs, outs):
        for got in (out, ref_codec.decode_sela(buf)):
            assert got.bits_per_sample == w.bits_per_sample
            for a, b in zip(got.channels, w.channels):
                np.testing.assert_array_equal(a, b)


def test_encode_files_runs_encode_wavs_engine_on_card(dev, monkeypatch):
    """encode_files of a 16-bit mono group (the int16 wire) and a mixed
    16/24-bit stereo group (the int32 wire), 4 full chunks each: the card
    packs their plain blocks, every full chunk but a group's first replays
    its CUDA graph, and each file's stream is its encode_wav stream."""
    from sela_tpu_torch.codec import step_graph
    from sela_tpu_torch.codec.corpus import encode_files
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.metrics import Metrics

    monkeypatch.setattr(step_graph, "GRAPHS", step_graph.StepGraphs())
    rng = np.random.default_rng(20)
    # mono, then stereo: 12 frames a group, 4 full chunks of 3
    files = [(1, 16, 2048 * 5 + 11), (1, 16, 2048 * 6),
             (2, 16, 2048 * 4 + 700), (2, 24, 2048 * 5 + 3), (2, 16, 900)]
    wavs = [WavData(44100, bits, list(_audio(rng, nch, n, bits=bits)))
            for nch, bits, n in files]
    m = Metrics()
    bufs = encode_files(wavs, chunk_frames=3, device="cuda", metrics=m)
    c = m.counters
    assert c["chunks"] == 8 and c["pack_blocks_device"] > 0
    assert c["step_graph_captures"] == 2 and c["step_graph_replays"] == 6
    for w, buf in zip(wavs, bufs):
        assert buf == encode_wav(w, chunk_frames=3, device="cuda")


def test_stream_decode_on_card(dev):
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.stream import StreamingPlayer, decode_stream
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(6)
    rows = _audio(rng, 2, 2048 * 5 + 17)
    buf = ref_codec.encode_wav(WavData(44100, 16, list(rows)))
    want = decode_sela(buf, device="cuda")
    blocks = list(decode_stream(buf, chunk_frames=2, device="cuda"))
    assert len(blocks) == 6
    pcm = np.concatenate(blocks)
    played = np.concatenate(list(StreamingPlayer(buf, chunk_frames=4)))
    for c in range(2):
        np.testing.assert_array_equal(pcm[:, c], want.channels[c])
        np.testing.assert_array_equal(played[:, c], rows[c])


def test_traced_player_on_a_cd_track(dev):
    """A 3-minute CD stream (3,876 frames, 31 chunks of 128) through a
    StreamingPlayer with a sink on the card: block for block decode_sela's
    PCM, every stage and counter recorded, and no thread left behind."""
    import chip_smoke as cs
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.codec.stream import StreamingPlayer
    from sela_tpu_torch.ref.wav import WavData
    from sela_tpu_torch.utils.metrics import Metrics

    w = WavData(44100, 16, cs.make_track(180.0, 44100, 16, seed=0))
    buf = encode_wav(w, device="cuda")
    want = decode_sela(buf, device="cuda")
    m = Metrics()
    player = StreamingPlayer(buf, device="cuda", metrics=m)
    blocks = list(player)
    assert not player._thread.is_alive()
    assert [len(b) for b in blocks] == [2048] * 3875 + [w.n_samples
                                                        - 3875 * 2048]
    at = 0
    for b in blocks:
        assert b.dtype == np.int32
        for c in range(2):
            np.testing.assert_array_equal(b[:, c],
                                          want.channels[c][at:at + len(b)])
        at += len(b)
    c = m.counters
    assert c["frames"] == c["blocks"] == 3876 and c["chunks"] == 31
    assert c["int32_wire_chunks"] == 0
    assert c["coded_bytes"] == len(buf) and c["pcm_bytes"] == w.n_samples * 4
    assert set(m.stage_s) - {"queue_wait"} == {
        "host_parse", "host_unpack", "rice_unpack", "device_dispatch",
        "device_fetch", "host_assemble"}
    assert m.stage_n["device_fetch"] == 31
    assert m.stage_n.get("queue_wait", 0) <= 3876   # puts that waited


def test_wrapping_stream_decodes_to_the_oracle_on_card(dev):
    """The 16-bit mono clip of tests/test_property.py with byte 27 ^= 5: its
    first subframe becomes order 0 with k_res 15 and its samples leave int16.
    decode_stream and decode_files give the oracle's int32 samples on the
    card, as on the CPU."""
    from sela_tpu_torch.codec.corpus import decode_files
    from sela_tpu_torch.codec.stream import decode_stream
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(0)
    buf = bytearray(ref_codec.encode_wav(WavData(
        44100, 16, [rng.integers(-2000, 2000, 700).astype(np.int32)])))
    buf[27] ^= 5
    buf = bytes(buf)
    want = ref_codec.decode_sela(buf).channels[0]
    assert (want.min(), want.max()) == (-95390, 97155)
    k_lpc.launches = k_iir.launches = 0
    for device in ("cuda", "cpu"):
        blocks = list(decode_stream(buf, chunk_frames=1, device=device))
        for got in (np.concatenate(blocks)[:, 0],
                    decode_files([buf], chunk_frames=1,
                                 device=device)[0].channels[0]):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    assert k_lpc.launches == k_iir.launches == 2   # one each a card path


def _frames(rng, F: int, C: int, S: int = 2048, bits: int = 16):
    """[F, C, S] int32 frames of _audio channels, the last one a tail."""
    rows = _audio(rng, C, F * S, bits=bits)
    x = np.ascontiguousarray(rows.reshape(C, F, S).transpose(1, 0, 2))
    nv = np.full(F, S, np.int32)
    nv[-1] = S - 321
    x[-1, :, nv[-1]:] = 0
    return x, nv


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0"] * 3],
                         ids=["1", "3"])
@pytest.mark.parametrize("partition", [1, 4])
def test_sharded_steps_equal_unsharded_on_card(dev, devices, partition):
    """F = 10 over 1 and 3 shards of cuda:0 (the last padded): the encode
    equals the unsharded encode_step on the card, key for key, and the
    sharded codec step is exact, its PCM the input's."""
    from sela_tpu_torch.codec.pipeline import encode_step
    from sela_tpu_torch.parallel import mesh

    x, nv = _frames(np.random.default_rng(partition + len(devices)), 10, 2)
    m = mesh.data_mesh(devices=devices)
    got = mesh.sharded_encode_step(m, partition=partition)(x, nv)
    want = encode_step(torch.from_numpy(x).to(dev), torch.from_numpy(nv).to(dev),
                       partition=partition)
    for key in want:
        assert got[key].device == want[key].device, key
        assert torch.equal(got[key], want[key]), key
    pcm, exact = mesh.sharded_codec_step(m, partition=partition)(x, nv)
    assert bool(exact.all())
    valid = np.arange(2048)[None, None, :] < nv[:, None, None]
    np.testing.assert_array_equal(np.where(valid, pcm.cpu().numpy(), 0), x)


def test_dryrun_multichip_on_card(dev):
    from sela_tpu_torch.parallel import mesh

    x, nv = _frames(np.random.default_rng(12), 9, 2)
    before = k_enc.launches["quarter_counts"]
    mesh.dryrun_multichip(mesh.data_mesh(devices=["cuda:0"] * 4), x, nv)
    assert k_enc.launches["quarter_counts"] > before


@pytest.mark.parametrize("n_hosts", [1, 3])
def test_encode_shard_merge_equals_encode_wav_on_card(dev, tmp_path, n_hosts):
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.parallel import multihost
    from sela_tpu_torch.ref.wav import WavData

    rows = _audio(np.random.default_rng(13), 2, 2048 * 7 + 99)
    w = WavData(44100, 16, list(rows))
    for rank in range(n_hosts):
        multihost.encode_shard(w, str(tmp_path), rank, n_hosts,
                               chunk_frames=2)   # the card by default
    out = str(tmp_path / "merged.sela")
    multihost.merge_shards(str(tmp_path), n_hosts, out)
    with open(out, "rb") as f:
        assert f.read() == encode_wav(w, device="cuda")


CHAIN_CASES = [(512, 1 << 16), (512, 1 << 19), (8, 1 << 20), (8, 1 << 23),
               (1, 0), (1, 1), (1, 1000), (3, 17), (8, 1000)]


@pytest.mark.parametrize("rows,steps", CHAIN_CASES)
def test_int_chain_kernel_matches_plain(dev, rows, steps):
    """K9 at the roofline tool's four readings and on the edges: one row,
    T = 0 and 1, a T that is not a multiple of the unroll, INT32_MIN and
    INT32_MAX inputs; exact."""
    from sela_tpu_torch.kernels import chain as k_chain
    from sela_tpu_torch.ops.chain import int_chain, int_chain_reference

    x = np.random.default_rng(rows + steps).integers(
        -(1 << 31), 1 << 31, (rows, 128), dtype=np.int64).astype(np.int32)
    x[0, :3] = (-(1 << 31), (1 << 31) - 1, 0)
    xd = torch.from_numpy(x).to(dev)
    before = k_chain.launches
    got = int_chain(xd, steps)
    assert k_chain.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, int_chain_reference(xd, steps))
    assert torch.equal(got.cpu(), int_chain_reference(torch.from_numpy(x),
                                                      steps))


def test_int_chain_wrapper_refuses_bad_inputs_on_card(dev):
    from sela_tpu_torch.ops.chain import int_chain

    ok = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="int32"):
        int_chain(ok.long(), 10)
    with pytest.raises(ValueError, match="128"):
        int_chain(torch.zeros((8, 64), dtype=torch.int32, device=dev), 10)
    with pytest.raises(ValueError, match="steps"):
        int_chain(ok, -1)
    with pytest.raises(ValueError, match="contiguous"):
        int_chain(torch.zeros((128, 8), dtype=torch.int32, device=dev).T, 10)
