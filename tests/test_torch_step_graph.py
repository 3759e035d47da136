"""encode_wav's device step replayed as a CUDA graph (codec/step_graph.py).

On the card every full chunk after a shape's first replays one captured
graph; a tail chunk, a track shorter than a chunk and the first full chunk
run eagerly. The streams must be the eager path's byte for byte, which the
tests get by making the graph map refuse (`_Refusing`). The tests marked
`cuda` need a card and skip without one; the file imports neither JAX nor
the JAX package:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_graph.py -q
"""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from sela_tpu_torch.codec import step_graph
from sela_tpu_torch.codec.decoder import decode_sela
from sela_tpu_torch.codec.encoder import device_chunk, encode_wav
from sela_tpu_torch.codec.pipeline import encode_step
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.format import FRAME_SIZE
from sela_tpu_torch.kernels import coeffs as k_lpc
from sela_tpu_torch.kernels import encode as k_enc
from sela_tpu_torch.kernels import pack as k_pack
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils.metrics import Metrics

COUNTERS = ("step_graph_replays", "step_graph_captures", "step_eager")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def graphs(monkeypatch):
    """A fresh graph map for the test, so its captures count from none."""
    fresh = step_graph.StepGraphs()
    monkeypatch.setattr(step_graph, "GRAPHS", fresh)
    return fresh


class _Refusing:
    """A graph map that holds nothing and captures nothing: every chunk
    runs the eager step."""

    def get(self, key):
        return None

    def capture(self, *args):
        return False


def _eager(w: WavData, monkeypatch, **kw) -> bytes:
    with monkeypatch.context() as mp:
        mp.setattr(step_graph, "GRAPHS", _Refusing())
        return encode_wav(w, device="cuda", **kw)


def _track(seed: int, frames: float, chans: int = 2, bits: int = 16,
           frame_size: int = FRAME_SIZE) -> WavData:
    """`frames` frames of tonal audio with noise, a channel each."""
    rng = np.random.default_rng(seed)
    n = int(frames * frame_size)
    t = np.arange(n)
    lim = (1 << (bits - 1)) - 1
    out = []
    for c in range(chans):
        f = rng.uniform(0.002, 0.05, 3)
        x = sum(np.sin(t * fi + rng.uniform(0, 6)) for fi in f)
        x = 0.2 * lim * x / 3 + rng.normal(0, lim * 2e-3, n)
        out.append(np.round(x).astype(np.int32))
    return WavData(44100 if bits == 16 else 96000, bits, out)


def _launches() -> dict:
    return {"lpc": k_lpc.launches, "pack": k_pack.launches, **k_enc.launches}


def _encode_counted(w: WavData, **kw):
    """encode_wav on the card with a sink: (stream, counters, launches)."""
    m = Metrics()
    before = _launches()
    buf = encode_wav(w, device="cuda", metrics=m, **kw)
    after = _launches()
    return (buf, {k: m.counters.get(k, 0) for k in COUNTERS},
            {k: after[k] - before[k] for k in after})


def _check_counts(counters: dict, launches: dict, F: int, chunk: int,
                  first: bool, v2: bool):
    """A track of F frames in chunks of `chunk`: every full chunk replays,
    but the first full one of a new key, which runs eagerly and captures;
    the tail runs eagerly; the kernels launch as the eager path does."""
    full, chunks = F // chunk, -(-F // chunk)
    captured = 1 if first and full else 0
    assert counters == {"step_graph_replays": full - captured,
                        "step_graph_captures": captured,
                        "step_eager": chunks - full + captured}
    assert launches == {
        "lpc": chunks, "autocorr": chunks, "levinson": chunks,
        "fir_rice": chunks, "ksel": chunks,
        "quarter_counts": chunks if v2 else 0,
        "pack": 0 if v2 else 2 * chunks}


CASES = [
    # channels, bits, frames (a fraction: a tail), chunk_frames, profile
    pytest.param(2, 16, 9.3, 2, None, id="stereo16-v1-tail"),
    pytest.param(2, 24, 7.6, 2, BitstreamProfile(residue_partition=4),
                 id="stereo24-v2-tail"),
    pytest.param(1, 16, 8, 2, None, id="mono16-v1"),
    pytest.param(2, 16, 3.5, 512, None, id="stereo16-shorter-than-a-chunk"),
    pytest.param(2, 16, 1100.2, 512, None, id="stereo16-v1-512"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("chans,bits,frames,chunk,profile", CASES)
def test_replayed_streams_are_the_eager_streams(dev, graphs, monkeypatch,
                                                chans, bits, frames, chunk,
                                                profile):
    """Two tracks of one shape in a row, so the second reuses the first's
    graph: each stream is the eager path's byte for byte and decodes to its
    input on the card; the counters and launches are as _check_counts says."""
    for i, seed in enumerate((1, 2)):
        w = _track(seed, frames, chans, bits)
        buf, counters, launches = _encode_counted(w, chunk_frames=chunk,
                                                  profile=profile)
        assert buf == _eager(w, monkeypatch, chunk_frames=chunk,
                             profile=profile)
        back = decode_sela(buf, device="cuda")
        assert all(np.array_equal(a, b)
                   for a, b in zip(back.channels, w.channels))
        _check_counts(counters, launches, -(-len(w.channels[0]) // FRAME_SIZE),
                      chunk, first=i == 0, v2=profile is not None)


def _loud_chunk_track(loud: np.ndarray, quiet: WavData, chunk: int,
                      at: int) -> WavData:
    """quiet with chunk `at` (of `chunk` frames) replaced by loud."""
    lo, hi = at * chunk * FRAME_SIZE, (at + 1) * chunk * FRAME_SIZE
    chans = [c.copy() for c in quiet.channels]
    for c in chans:
        c[lo:hi] = loud[: hi - lo]
    return WavData(quiet.sample_rate, quiet.bits_per_sample, chans)


@pytest.mark.cuda
def test_a_replayed_chunk_keeps_its_own_int32_residues(dev, graphs,
                                                       monkeypatch):
    """v1 under rice_k_max=7, chunks of 4 frames: a loud chunk's residue
    blocks escape (the host packs them from its int32 residues, fetched
    after its event), and the three quiet chunks after it replay the graph
    before it is collected. Its residues must be its own, not the static
    outputs' of a later replay. The loud chunk is chunk 1 (a replay on the
    first track) and chunk 0 (on the second)."""
    rng = np.random.default_rng(5)
    quiet = _track(3, 26.4, 2, 16)
    loud = rng.integers(-32768, 32768, 4 * FRAME_SIZE).astype(np.int32)
    profile = BitstreamProfile(rice_k_max=7)
    for at in (1, 0):
        w = _loud_chunk_track(loud, quiet, 4, at)
        m = Metrics()
        buf = encode_wav(w, chunk_frames=4, profile=profile, device="cuda",
                         metrics=m)
        assert m.counters["int32_fetch"] == 1
        assert m.counters["step_graph_replays"] >= 5
        assert buf == _eager(w, monkeypatch, chunk_frames=4, profile=profile)
        back = decode_sela(buf, device="cuda")
        assert all(np.array_equal(a, b)
                   for a, b in zip(back.channels, w.channels))


@pytest.mark.cuda
def test_a_replayed_v2_chunk_that_leaves_int16_fetches_its_own(dev, graphs,
                                                               monkeypatch):
    """v2 on 16-bit PCM, chunks of 2 frames: a full-scale square wave's
    residues leave int16 (fits16 false), so that chunk's int32 residues are
    fetched after its event, three replays later. The loud chunk is chunk 1
    and, on the second track, chunk 0."""
    t = np.arange(2 * FRAME_SIZE)
    square = np.where((t // 300) % 2 == 0, 32767, -32768).astype(np.int32)
    quiet = _track(4, 12.5, 2, 16)
    profile = BitstreamProfile(residue_partition=4)
    for at in (1, 0):
        w = _loud_chunk_track(square, quiet, 2, at)
        m = Metrics()
        buf = encode_wav(w, chunk_frames=2, profile=profile, device="cuda",
                         metrics=m)
        assert m.counters["int32_fetch"] == 1
        assert m.counters["step_graph_replays"] >= 4
        assert buf == _eager(w, monkeypatch, chunk_frames=2, profile=profile)
        back = decode_sela(buf, device="cuda")
        assert all(np.array_equal(a, b)
                   for a, b in zip(back.channels, w.channels))


@pytest.mark.cuda
def test_two_threads_share_a_graph(dev, graphs, monkeypatch):
    """Two threads encode different tracks of one shape at once, one on a
    side stream, three times each: every stream is the eager path's."""
    tracks = [_track(10 + i, 13.7, 2, 16) for i in range(2)]
    want = [_eager(w, monkeypatch, chunk_frames=2) for w in tracks]
    got: dict = {}

    def work(i: int):
        stream = torch.cuda.Stream() if i else torch.cuda.current_stream()
        with torch.cuda.stream(stream):
            got[i] = [encode_wav(tracks[i], chunk_frames=2, device="cuda")
                      for _ in range(3)]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == [want[0]] * 3 and got[1] == [want[1]] * 3


@pytest.mark.cuda
def test_an_evicted_graph_is_captured_again(dev, monkeypatch):
    """A map of one graph, two keys in turn: each encode evicts the other's
    graph and captures its own; the streams stay the eager path's."""
    monkeypatch.setattr(step_graph, "GRAPHS", step_graph.StepGraphs(size=1))
    w = _track(6, 6.2, 2, 16)
    want = {cf: _eager(w, monkeypatch, chunk_frames=cf) for cf in (2, 3)}
    for cf in (2, 3, 2):
        buf, counters, _ = _encode_counted(w, chunk_frames=cf)
        assert buf == want[cf]
        assert counters["step_graph_captures"] == 1


def test_a_cpu_encode_replays_nothing(monkeypatch):
    """On the CPU every chunk runs eagerly, and no graph is captured."""
    fresh = step_graph.StepGraphs()
    monkeypatch.setattr(step_graph, "GRAPHS", fresh)
    w = _track(7, 5.5, 2, 16, frame_size=256)
    m = Metrics()
    encode_wav(w, frame_size=256, chunk_frames=2, device="cpu", metrics=m)
    assert {k: m.counters.get(k, 0) for k in COUNTERS} == {
        "step_graph_replays": 0, "step_graph_captures": 0, "step_eager": 3}
    assert not fresh._graphs


def test_device_chunk_is_encode_step_and_its_plan_on_the_cpu():
    """device_chunk's plan is the PLAN columns then the coefficients of
    encode_step's outputs; off the card's v1 path it hands back the wire
    residues and fits16, on it the packed words."""
    from sela_tpu_torch.codec.encoder import PLAN

    w = _track(8, 2.5, 2, 16, frame_size=256)
    x = torch.stack([torch.from_numpy(c[:2 * 256].reshape(2, 256))
                     for c in w.channels], dim=1).to(torch.int16)
    nv = torch.tensor([256, 256], dtype=torch.int32)
    out = encode_step(x, nv)
    got = device_chunk(x, nv, on_card=False, wire16=True)
    cols = [out[k] for k in PLAN] + [out["qcoeffs"][..., i] for i in range(32)]
    assert torch.equal(got["plan"], torch.stack(cols, dim=-1))
    assert torch.equal(got["res"], out["res16"])
    assert torch.equal(got["fits16"], out["fits16"])
    assert torch.equal(got["residues"], out["residues"])
    packed = device_chunk(x, nv, on_card=True, wire16=True)
    assert packed["nwords"].shape == (2 * 2 * 2,)
    assert torch.equal(packed["nwords"][:4], out["nw_res"].reshape(-1).long())


class _FakeGraph:
    """StepGraph's place in a StepGraphs test on the CPU."""

    closed: list = []

    def __init__(self, fn, shape, dtype, device):
        self.fn = fn

    def close(self):
        _FakeGraph.closed.append(self.fn)


def test_graph_map_keeps_the_most_recently_used(monkeypatch):
    """StepGraphs captures a key once, hands back the same graph, and past
    its size drops (and closes) the least recently used."""
    monkeypatch.setattr(step_graph, "StepGraph", _FakeGraph)
    monkeypatch.setattr(_FakeGraph, "closed", [])
    g = step_graph.StepGraphs(size=2)
    assert g.get("a") is None
    assert g.capture("a", "fa", (1,), None, None)
    assert not g.capture("a", "fa2", (1,), None, None)
    assert g.get("a").fn == "fa"
    assert g.capture("b", "fb", (1,), None, None)
    g.get("a")   # now b is the least recently used
    assert g.capture("c", "fc", (1,), None, None)
    assert _FakeGraph.closed == ["fb"]
    assert g.get("b") is None and g.get("a").fn == "fa"
    assert g.get("c").fn == "fc"
