"""The encoder's stream buffer (codec/encoder.py::StreamBuffer): the frame
emit writes each coded byte once, into a uint8 array the calling thread
keeps from run to run, and the stream is copied out of it once.

The streams are byte-identical to the composition the buffer replaced
(bitio.emit_frames' bytes a chunk, joined behind the header by
ref/container.py::serialize_file) over the same pack_frames outputs; a
buffer reused by shorter and longer runs, grown mid-run, or held by two
threads at once gives the same bytes; and bitio.emit_frames refuses an
`out` too short before it writes. Imports nothing of JAX."""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from sela_tpu_torch.codec import corpus, encoder
from sela_tpu_torch.config import BitstreamProfile
from sela_tpu_torch.format import SYNC
from sela_tpu_torch.native import bitio
from sela_tpu_torch.ref import container
from sela_tpu_torch.ref.wav import WavData
from sela_tpu_torch.utils.metrics import Metrics

FS, CHUNK = 64, 4   # small frames and chunks: several chunks a track


def _music(seed: int, n: int, C: int, bits: int = 16) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 0.4 * ((1 << (bits - 1)) - 1)
    return [np.round(amp * np.sin(t * (0.03 + 0.02 * c))
                     + rng.normal(0, amp / 300, n)).astype(np.int32)
            for c in range(C)]


def _old_stream(w: WavData, profile=None, tags=None,
                chunk_frames: int = CHUNK) -> bytes:
    """encode_wav's stream as it was composed before the buffer: each
    chunk's frames as bytes (bitio.emit_frames), joined behind the header
    by serialize_file, then the tags trailer."""
    p = profile or BitstreamProfile(frame_size=FS)
    frames: list[bytes] = []
    encoder.encode_chunks(
        [w.channels], torch.int16 if w.bits_per_sample <= 16 else torch.int32,
        p.frame_size, torch.device("cpu"), chunk_frames,
        dict(allow_ms=p.mid_side != "off" and w.bits_per_sample <= 24,
             max_order=p.max_order, rice_k_max=p.rice_k_max,
             partition=p.residue_partition,
             ms_mode="exact" if p.mid_side == "exact" else "est"), None,
        lambda start, fcount, packed, nv: frames.append(
            encoder.serialize_frames(packed, nv, 0, fcount)))
    F = -(-w.n_samples // p.frame_size)
    buf = container.serialize_file(container.SelaHeader(
        w.sample_rate, w.bits_per_sample, w.n_channels, F), frames)
    return buf + (container.serialize_tags(tags) if tags else b"")


def _encode(w: WavData, profile=None, tags=None, metrics=None,
            chunk_frames: int = CHUNK) -> bytes:
    return encoder.encode_wav(w, frame_size=FS, chunk_frames=chunk_frames,
                              profile=profile, metrics=metrics, tags=tags,
                              device="cpu")


def _in_a_new_thread(fn):
    """fn() on a thread of its own, whose stream buffer starts empty."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    assert out, "the thread raised"
    return out[0]


def _bursts(seed: int, n: int, C: int) -> list[np.ndarray]:
    """24-bit noise loud in the first quarter of each frame and quiet in
    the rest: v2 partitions its residue blocks."""
    rng = np.random.default_rng(seed)
    env = np.where(np.arange(n) // (FS // 4) % 4 == 0, 1 << 20, 1 << 6)
    return [np.round(rng.normal(0, 1, n) * env).astype(np.int32)
            for _ in range(C)]


CASES = {
    # 11 frames: two full chunks and a tail of 3
    "v1_stereo_tail_chunk": (WavData(44100, 16, _music(1, 10 * FS + 17, 2)),
                             None, None),
    # partitioned blocks carry RESIDUE_PARTS bytes more
    "v2_partitioned": (
        WavData(96000, 24, _bursts(2, 9 * FS + 5, 2)),
        BitstreamProfile(frame_size=FS, residue_partition=4), None),
    "mono": (WavData(22050, 16, _music(3, 7 * FS, 1)), None, None),
    "shorter_than_a_chunk": (WavData(48000, 16, _music(4, 2 * FS + 9, 2)),
                             None, None),
    "tags": (WavData(44100, 16, _music(5, 5 * FS + 1, 2)), None,
             {"TITLE": "a title", "ART": bytes(range(40))}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_is_the_old_composition(case):
    w, profile, tags = CASES[case]
    want = _old_stream(w, profile, tags)
    assert _encode(w, profile, tags) == want
    if profile is not None and profile.residue_partition > 1:
        # the case holds partitioned blocks, whose 4 sub-k bytes count
        h = container.parse_header(want)
        sf, _ = bitio.scan_frames(want, container.HEADER_SIZE, h.num_frames,
                                  h.channels, SYNC, FS)
        assert (sf["k_res"] == 32).any()


def _batch() -> list[WavData]:
    """Mono and stereo, 16- and 24-bit files whose frame counts end
    mid-chunk (CHUNK 4): 5, 3, 1, 6 and 2 frames."""
    return [WavData(44100, 16, _music(10, 4 * FS + 7, 2)),
            WavData(22050, 16, _music(11, 3 * FS, 1)),
            WavData(48000, 24, _music(12, FS - 9, 2, bits=24)),
            WavData(44100, 16, _music(13, 5 * FS + 1, 1)),
            WavData(44100, 16, _music(14, 2 * FS, 2))]


def test_encode_files_streams_are_the_old_composition():
    wavs = _batch()
    m = Metrics()
    bufs = corpus.encode_files(wavs, chunk_frames=CHUNK, frame_size=FS,
                               device="cpu", metrics=m)
    for w, buf in zip(wavs, bufs):
        assert buf == _old_stream(w)
    # one assembly a file, none of them nested in the chunks' stages
    assert m.stage_n["host_assemble"] == len(wavs)
    assert m.counters["coded_bytes"] == sum(len(b) for b in bufs)


def test_reuse_by_shorter_and_longer_runs():
    """A long, a short, then a longer encode on one thread: each exact;
    the buffer is allocated for the first and grown for the third; the
    streams returned before are unchanged."""
    long_, short, longer = (WavData(44100, 16, _music(s, n, 2))
                            for s, n in ((20, 9 * FS + 3), (21, FS + 1),
                                         (22, 14 * FS + 30)))

    def run():
        got = []
        for w in (long_, short, longer):
            m = Metrics()
            got.append((_encode(w, metrics=m),
                        m.counters["emit_buffer_allocs"]))
        return got

    got = _in_a_new_thread(run)
    assert [a for _, a in got] == [1, 0, 1]
    kept = [bytes(b) for b, _ in got]
    for (buf, _), w in zip(got, (long_, short, longer)):
        assert buf == _old_stream(w)
    assert [b for b, _ in got] == kept


def test_allocs_read_one_then_zero():
    w = WavData(44100, 16, _music(30, 6 * FS + 2, 2))

    def run():
        counts = []
        for _ in range(3):
            m = Metrics()
            _encode(w, metrics=m)
            counts.append(m.counters["emit_buffer_allocs"])
        return counts

    assert _in_a_new_thread(run) == [1, 0, 0]


def test_two_threads_at_once_are_exact():
    wa = WavData(44100, 16, _music(40, 12 * FS + 3, 2))
    wb = WavData(96000, 24, _music(41, 10 * FS + 50, 2, bits=24))
    want = {id(wa): _old_stream(wa), id(wb): _old_stream(wb)}
    start = threading.Barrier(2)
    got: dict = {}

    def run(w):
        start.wait()
        got[id(w)] = [_encode(w, chunk_frames=2) for _ in range(3)]

    threads = [threading.Thread(target=run, args=(w,)) for w in (wa, wb)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for w in (wa, wb):
        assert got[id(w)] == [want[id(w)]] * 3


def test_a_short_bound_grows_the_buffer_mid_run(monkeypatch):
    """Were stream_bound ever short, each write that finds too little
    room grows the buffer, its used prefix copied: the stream holds."""
    w, _, tags = CASES["tags"]
    want = _old_stream(w, tags=tags)
    monkeypatch.setattr(encoder, "stream_bound", lambda *a: 16)

    def run():
        m = Metrics()
        return _encode(w, tags=tags, metrics=m), m.counters

    buf, counters = _in_a_new_thread(run)
    assert buf == want
    assert counters["emit_buffer_allocs"] > 2


def test_bound_holds_escaped_blocks():
    """Full-scale 32-bit noise escapes every block (32 bits a value):
    the stream still fits stream_bound."""
    rng = np.random.default_rng(50)
    chans = [rng.integers(-(1 << 31), (1 << 31) - 1, 6 * FS + 3,
                          dtype=np.int64).astype(np.int32) for _ in range(2)]
    w = WavData(48000, 32, chans)
    buf = _encode(w)
    assert buf == _old_stream(w)
    h = container.parse_header(buf)
    sf, _ = bitio.scan_frames(buf, container.HEADER_SIZE, h.num_frames,
                              h.channels, SYNC, FS)
    assert (sf["k_res"] == 31).all()
    assert len(buf) <= encoder.stream_bound([h.num_frames], 2, FS, False)


def _one_frame_args():
    """emit_frames' arguments for one mono frame of 2 coefficient and 3
    residue words: 6 + 11 + 4 (2 + 3) = 37 bytes."""
    i32 = lambda *v: np.array(v, np.int32)   # noqa: E731
    return (1, 1, SYNC, i32(FS), i32(0), i32(1), i32(2), i32(4), i32(2),
            i32(5), i32(3), np.arange(2, dtype=np.uint32),
            np.arange(3, dtype=np.uint32))


def test_emit_into_out_writes_the_bytes_and_returns_their_count():
    args = _one_frame_args()
    want = bitio.emit_frames(*args)
    assert len(want) == 37 == bitio.frames_size(1, args[9], args[8],
                                                args[10])
    out = np.full(50, 0xAB, np.uint8)
    assert bitio.emit_frames(*args, out=out) == 37
    assert out[:37].tobytes() == want and (out[37:] == 0xAB).all()


def test_emit_into_too_short_an_out_raises_before_writing():
    out = np.full(36, 0xAB, np.uint8)
    with pytest.raises(ValueError, match="36 bytes of the frames' 37"):
        bitio.emit_frames(*_one_frame_args(), out=out)
    assert (out == 0xAB).all()


def test_host_assemble_is_timed_once_a_stream():
    m = Metrics()
    w, _, tags = CASES["tags"]
    _encode(w, tags=tags, metrics=m)
    _encode(w, metrics=m)
    assert m.stage_n["host_assemble"] == 2
    assert m.stage_n["emit"] == m.stage_n["host_pack"] == m.counters["chunks"]
