"""Partitioned residues (the v2 profile, residue_partition=4) in the port, on
the CPU, against the JAX package, the oracle and the input.

(a) `quarter_counts_reference`, the plain version of K8, equals the Pallas
    `quarter_counts_pallas` in interpret mode, and (b) masking each quarter
    and running `sela_tpu.ops.rice.bit_counts`, bit for bit;
(c) the port's `_render_rows(partition=4)`, given the JAX analysis'
    (order, q), equals the JAX `_render_rows(partition=4)` in every planning
    array, some rows partitioned and some not;
(d) `encode_wav(device="cpu")` v2 streams of a percussive clip decode
    bit-exactly through the oracle, the JAX decoder, JAX streaming decode and
    the port's decoder; at 16 bits they are more than 1% smaller than the
    port's v1 stream and no more than 0.5% larger than the JAX encoder's v2
    stream (the float analysis is non-normative); at 24 bits (exact
    mid/side) no larger than v1; the chunking never changes the bytes;
(e) 32-bit v2 with INT32_MIN and INT32_MAX samples; (f) v2 never grows on
    stationary content; (g) the CLI's --partition-residues, --frame-size and
    --tag; (h) encode_step rejects other partitions; plus the wrapper's
    checks and K8's place on the path (once a chunk under v2, never under
    v1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sela_tpu.codec import decoder as jax_decoder
from sela_tpu.codec import encoder as jax_encoder
from sela_tpu.codec.pipeline import _render_rows as jax_render_rows
from sela_tpu.codec.stream import decode_stream as jax_decode_stream
from sela_tpu.config import BitstreamProfile as JaxProfile
from sela_tpu.format import RICE_PARTITION_MARKER
from sela_tpu.kernels.encode import analyze_pallas, quarter_counts_pallas
from sela_tpu.ops import rice as jax_rice
from sela_tpu.ref import codec as ref_codec
from sela_tpu.ref import container
from sela_tpu.ref.wav import WavData
from sela_tpu_torch.codec import pipeline
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.ops import rice as port_rice
from test_partition import percussive_wav

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
S = 2048
CHUNK = 8   # the JAX encoder's and decoder's chunk, as in the other tests
V2 = BitstreamProfile(residue_partition=4)
NV_EDGES = (0, 1, 2, 3, 4, 5, 7, 1000, 2047, 2048)
RENDER_KEYS = ("e", "eff_order", "q_eff", "k_res", "kr4", "k_coeff", "nw_res",
               "nw_coeff", "block_bits")


def _residues(seed: int, B: int, N: int = S):
    """[B, N] int32 rows (uniform int32, Laplacian of many scales, INT32_MIN
    and INT32_MAX) and n_valid cycling through NV_EDGES (capped at N)."""
    rng = np.random.default_rng(seed)
    e = rng.integers(I32_MIN, I32_MAX + 1, (B, N), dtype=np.int64)
    scale = 2.0 ** rng.uniform(0, 20, B)
    lap = np.round(rng.laplace(0, 1, (B, N)) * scale[:, None])
    e = np.where(np.arange(B)[:, None] % 2, e, np.clip(lap, -1e9, 1e9))
    e = e.astype(np.int32)
    e[0, : min(N, 6)] = (I32_MIN, I32_MAX, 0, -1, 1, I32_MIN)[: min(N, 6)]
    if B > 3:
        e[3] = I32_MIN                        # every code is 2^32 - 1
    nv = np.minimum(np.resize(np.array(NV_EDGES, np.int32), B), N)
    return e, nv.astype(np.int32)


def _markers(buf: bytes) -> int:
    """Subframes of a stream that carry the partition marker."""
    h = container.parse_header(buf)
    pos, seen = container.HEADER_SIZE, 0
    for _ in range(h.num_frames):
        sfs, _, pos = container.parse_frame(buf, pos, h.channels)
        seen += sum(sf.k_res == RICE_PARTITION_MARKER for sf in sfs)
    return seen


def _same(out, w, who=""):
    assert (out.sample_rate, out.bits_per_sample) == (
        w.sample_rate, w.bits_per_sample), who
    for a, b in zip(out.channels, w.channels):
        np.testing.assert_array_equal(a, b, err_msg=who)


# ------------------------------------------------------- (a), (b) K8 plain --

@pytest.mark.parametrize("B", [1, 70])
def test_quarter_counts_plain_matches_pallas(B):
    e, nv = _residues(B, B)
    if B == 1:
        nv[0] = 5
    got = port_rice.quarter_counts(torch.from_numpy(e), torch.from_numpy(nv))
    assert got.dtype == torch.int32 and got.shape == (B, 4, 32)
    want = quarter_counts_pallas(jnp.asarray(e), jnp.asarray(nv),
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N", [100, S])
def test_quarter_counts_plain_matches_masked_bit_counts(N):
    e, nv = _residues(7 + N, 70, N)
    got = port_rice.quarter_counts_reference(torch.from_numpy(e),
                                             torch.from_numpy(nv)).numpy()
    n = np.arange(N)[None, :]
    for q in range(4):
        lo, hi = (q * nv) // 4, ((q + 1) * nv) // 4
        eq = np.where((n >= lo[:, None]) & (n < hi[:, None]), e, 0)
        want = jax_rice.bit_counts(jax_rice.zigzag(jnp.asarray(eq)))
        np.testing.assert_array_equal(got[:, q], np.asarray(want), err_msg=q)
    # row 3: INT32_MIN (zigzag 2^32 - 1, every bit) with nv = 3, so its
    # quarters hold 0, 1, 1 and 1 samples
    assert (got[3, 0] == 0).all() and (got[3, 1:] == 1).all()


@pytest.mark.parametrize("width", [1, 31, 32])
def test_quarter_counts_plain_matches_pallas_at_edges(width):
    """n_valid on the CUDA kernel's quarter and lane edges, rows whose
    widest zigzag code has `width` bits (the residue with it on every third
    row), 70 rows (not a multiple of the Pallas kernel's 64)."""
    rng = np.random.default_rng(width)
    widest = {1: -1, 31: -(1 << 30), 32: I32_MIN}[width]
    e = rng.integers(I32_MIN, I32_MAX + 1, (70, S), dtype=np.int64)
    e = np.clip(e, widest, -widest - 1).astype(np.int32)
    e[::3, 5] = widest
    nv = np.resize(np.array([1, 3, 4, 5, 127, 128, 129, S - 1, S, 0],
                            np.int32), 70)
    got = port_rice.quarter_counts(torch.from_numpy(e), torch.from_numpy(nv))
    want = quarter_counts_pallas(jnp.asarray(e), jnp.asarray(nv),
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = got.numpy()
    assert not counts[:, :, width:].any() and counts[0::3, :, width - 1].any()


def test_quarter_counts_rejects_rows_over_frame_size():
    """The CUDA kernel's per-lane counters hold a quarter of at most 2,048
    samples, so the wrapper refuses longer rows on every device."""
    e = torch.zeros((2, S + 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        port_rice.quarter_counts(e, torch.full((2,), S + 1, dtype=torch.int32))


def test_quarter_counts_rejects_bad_inputs():
    e = torch.zeros((4, 64), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_rice.quarter_counts(e.long(), n)
    with pytest.raises(TypeError):
        port_rice.quarter_counts(e, n.long())
    with pytest.raises(ValueError):
        port_rice.quarter_counts(e[0], n)
    with pytest.raises(ValueError):
        port_rice.quarter_counts(e, n[:3])
    with pytest.raises(ValueError):
        port_rice.quarter_counts(torch.zeros((64, 4), dtype=torch.int32).t(), n)
    with pytest.raises(ValueError):
        port_rice.quarter_counts(e.to("meta"), n.to("meta"))


# ------------------------------------------------------------ (c) render --

def _render_rows_input(B: int = 64):
    """B rows of 2,048 samples: percussive frames, random walks with bursts,
    silence, a wide noise row, and tails of 1000, 5, 3, 1 and 0 samples."""
    rng = np.random.default_rng(3)
    w = percussive_wav(1.0, seed=9)
    n_frames = len(w.channels[0]) // S
    xb = np.zeros((B, S), np.int64)
    for r in range(min(B // 2, 2 * n_frames)):
        xb[r] = w.channels[r % 2][(r // 2) * S : (r // 2 + 1) * S]
    for r in range(B // 2, B):
        steps = rng.normal(0, 10.0 ** rng.uniform(0, 3), S)
        steps[rng.integers(0, S, 3)] *= 200                 # bursts
        xb[r] = np.clip(np.round(np.cumsum(steps)), -(1 << 23), (1 << 23) - 1)
    xb[5] = rng.integers(-(1 << 25), 1 << 25, S)              # noisy, wide
    xb[6] = 0                                                 # silence
    nv = np.full(B, S, np.int32)
    nv[[3, 9, 10, 11, 12]] = (1000, 5, 3, 1, 0)
    xb[np.arange(S)[None, :] >= nv[:, None]] = 0
    return xb.astype(np.int32), nv


@pytest.mark.parametrize("k_max", [30, 7])
def test_partitioned_render_matches_jax_given_its_analysis(k_max):
    xb, nv = _render_rows_input()
    xj, nvj = jnp.asarray(xb), jnp.asarray(nv)
    order, q, _ = analyze_pallas(xj, nvj, 32, interpret=True)
    want = jax_render_rows(xj, q, order, nvj, k_max, False, True, 4)
    got = pipeline._render_rows(torch.from_numpy(xb),
                                torch.from_numpy(np.array(q)),
                                torch.from_numpy(np.array(order)),
                                torch.from_numpy(nv), k_max, 4)
    for key in RENDER_KEYS:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    part = got["k_res"].numpy() == RICE_PARTITION_MARKER
    assert 0 < part.sum() < len(part), part.sum()
    assert not part[nv < 4].any()
    assert (got["kr4"].numpy()[~part] == 0).all()


# -------------------------------------------------------- (d) encode_wav --

def _percussive(bits: int) -> WavData:
    """The percussive clip of tests/test_partition.py at 16 bits, or scaled
    to `bits` with fresh noise in the new low bits."""
    w = percussive_wav()
    if bits == 16:
        return w
    rng = np.random.default_rng(bits)
    shift = bits - 16
    lim = (1 << (bits - 1)) - 1
    chans = [np.clip((c.astype(np.int64) << shift)
                     + rng.integers(-(1 << (shift - 1)), 1 << (shift - 1),
                                    len(c)), -lim - 1, lim).astype(np.int32)
             for c in w.channels]
    if bits == 32:
        chans[0][100], chans[0][5000], chans[1][7] = I32_MIN, I32_MAX, I32_MIN
    return WavData(w.sample_rate, bits, chans)


@pytest.mark.parametrize("bits", [16, 24])
def test_v2_encode_decodes_everywhere_and_is_smaller(bits):
    w = _percussive(bits)
    mid_side = "auto" if bits == 16 else "exact"
    v2 = BitstreamProfile(mid_side=mid_side, residue_partition=4)
    buf = encode_wav(w, chunk_frames=2, profile=v2, device="cpu")
    assert _markers(buf) > 0
    _same(ref_codec.decode_sela(buf), w, "oracle")
    _same(jax_decoder.decode_sela(buf, chunk_frames=CHUNK), w, "jax")
    pcm = np.concatenate(list(jax_decode_stream(buf, chunk_frames=CHUNK)))
    for c, ch in enumerate(w.channels):
        np.testing.assert_array_equal(pcm[:, c], ch, err_msg="jax stream")
    _same(decode_sela(buf, chunk_frames=3, device="cpu"), w, "port")
    v1 = encode_wav(w, chunk_frames=2, profile=BitstreamProfile(
        mid_side=mid_side), device="cpu")
    if bits == 16:
        assert len(buf) < 0.99 * len(v1), (len(buf), len(v1))
        jax_buf = jax_encoder.encode_wav(
            w, chunk_frames=CHUNK, profile=JaxProfile(residue_partition=4))
        assert len(buf) <= 1.005 * len(jax_buf), (len(buf), len(jax_buf))
    else:
        assert len(buf) <= len(v1), (len(buf), len(v1))
    # the chunking is a runtime choice: it never changes the bytes
    assert encode_wav(w, chunk_frames=512, profile=v2, device="cpu") == buf


def test_v2_encode_32bit_extremes():
    w = _percussive(32)
    buf = encode_wav(w, chunk_frames=4, profile=V2, device="cpu")
    _same(ref_codec.decode_sela(buf), w, "oracle")
    _same(decode_sela(buf, device="cpu"), w, "port")
    assert len(buf) <= len(encode_wav(w, chunk_frames=4, device="cpu"))


def test_v2_never_grows_on_stationary():
    rng = np.random.default_rng(3)          # tests/test_partition.py's clip
    n = 6000
    tone = np.round(20000 * 0.7 * np.sin(np.arange(n) * 0.07)).astype(np.int32)
    noise = rng.integers(-500, 500, n).astype(np.int32)
    w = WavData(44100, 16, [tone + noise])
    v1 = encode_wav(w, device="cpu")
    v2 = encode_wav(w, profile=V2, device="cpu")
    assert len(v2) <= len(v1)
    _same(ref_codec.decode_sela(v2), w, "oracle")


def test_k8_runs_once_a_chunk_under_v2_only(monkeypatch):
    """Under v2 each chunk's render calls K8's wrapper once and K6's once;
    under v1 it never calls K8's."""
    calls = {"quarter_counts": 0, "ksel": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(pipeline, name, wrapped)

    spy("quarter_counts", port_rice.quarter_counts)
    spy("ksel", port_rice.ksel)
    w = percussive_wav(0.6, seed=6)                  # 13 frames: 7 chunks
    encode_wav(w, chunk_frames=2, device="cpu")
    assert calls == {"quarter_counts": 0, "ksel": 7}
    encode_wav(w, chunk_frames=2, profile=V2, device="cpu")
    assert calls == {"quarter_counts": 7, "ksel": 14}


# ------------------------------------------------------------ (g) CLI --

def test_cli_partition_residues_frame_size_and_tag(tmp_path, capsys):
    from sela_tpu.ref.wav import write_wav
    from sela_tpu_torch.cli import main

    w = percussive_wav(0.8)
    src, dst = tmp_path / "in.wav", tmp_path / "out.sela"
    write_wav(str(src), w)
    assert main(["encode", str(src), str(dst), "--cpu", "--partition-residues",
                 "--frame-size", "1024", "--tag", "title=x",
                 "--tag", "artist=a=b"]) == 0
    buf = dst.read_bytes()
    _same(ref_codec.decode_sela(buf), w, "oracle")
    assert container.parse_header(buf).num_frames == -(-w.n_samples // 1024)
    assert _markers(buf) > 0
    assert container.read_tags(buf) == {"title": "x", "artist": "a=b"}
    assert main(["verify", str(src), "--cpu", "--partition-residues"]) == 0
    assert "BIT-EXACT" in capsys.readouterr().out


# ---------------------------------------------------------- (h) profile --

@pytest.mark.parametrize("partition", [0, 2, 3, 8])
def test_encode_step_rejects_other_partitions(partition):
    x = torch.zeros((1, 2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="partition"):
        pipeline.encode_step(x, torch.full((1,), 64, dtype=torch.int32),
                             partition=partition)
