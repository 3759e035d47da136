"""The port's multi-host shard encode and merge (sela_tpu_torch/parallel/
multihost.py) on the CPU, case for case as tests/test_multihost.py holds the
JAX package's: the rank-ordered merge equals one `encode_wav` byte for byte,
a missing or corrupt part is caught. Also: `frame_ranges` equals JAX's, the
two packages' parts merge through either package's `merge_shards` to the
same bytes, and every merged file decodes through the oracle
(sela_tpu.ref.codec) to the input."""
import json

import numpy as np
import pytest

from sela_tpu.codec.encoder import encode_wav as jax_encode_wav
from sela_tpu.parallel import multihost as jax_multihost
from sela_tpu.ref import codec as ref_codec
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.parallel import multihost
from sela_tpu_torch.ref.wav import WavData

CHUNK = 8


def make_long_wav(rng, signal_factory, n=2048 * 7 + 300):
    return WavData(
        44100, 16,
        [signal_factory(rng, n, kind="ar"), signal_factory(rng, n, kind="tone")],
    )


def _encode(w):
    return encode_wav(w, chunk_frames=CHUNK, device="cpu")


def _shard_all(w, out_dir, n_hosts):
    for rank in range(n_hosts):
        multihost.encode_shard(w, str(out_dir), rank, n_hosts,
                               chunk_frames=CHUNK, device="cpu")


def _assert_decodes_to(buf, w):
    dec = ref_codec.decode_sela(buf)
    for a, b in zip(dec.channels, w.channels):
        np.testing.assert_array_equal(a, b)


def test_frame_ranges_cover_exactly():
    for n_samples, hosts in [(2048 * 7 + 300, 3), (2048, 2), (100, 4), (2048 * 8, 4)]:
        r = multihost.frame_ranges(n_samples, hosts)
        n_frames = -(-n_samples // 2048)
        assert r[0][0] == 0 and r[-1][1] == n_frames
        for (a, b), (c, d) in zip(r, r[1:]):
            assert b == c


@pytest.mark.parametrize("n_samples,hosts,frame_size", [
    (2048 * 7 + 300, 3, 2048), (2048, 2, 2048), (100, 4, 2048),
    (2048 * 8, 4, 2048), (1, 1, 2048), (10_000, 7, 1000), (25_840 * 2048, 4, 2048),
])
def test_frame_ranges_match_jax(n_samples, hosts, frame_size):
    assert (multihost.frame_ranges(n_samples, hosts, frame_size)
            == jax_multihost.frame_ranges(n_samples, hosts, frame_size))


def test_sharded_encode_merges_bit_exact(tmp_path, rng, signal_factory):
    w = make_long_wav(rng, signal_factory)
    single = _encode(w)
    n_hosts = 3
    _shard_all(w, tmp_path, n_hosts)
    out_path = str(tmp_path / "merged.sela")
    info = multihost.merge_shards(str(tmp_path), n_hosts, out_path)
    merged = open(out_path, "rb").read()
    assert merged == single  # rank-ordered gather is bit-exact
    _assert_decodes_to(merged, w)
    assert info["frames"] == -(-w.n_samples // 2048)


def test_missing_shard_detected_and_recoverable(tmp_path, rng, signal_factory):
    w = make_long_wav(rng, signal_factory, n=2048 * 5)
    n_hosts = 2
    multihost.encode_shard(w, str(tmp_path), 0, n_hosts, chunk_frames=CHUNK,
                           device="cpu")
    assert multihost.missing_shards(str(tmp_path), n_hosts) == [1]
    with pytest.raises(RuntimeError, match="missing shards"):
        multihost.merge_shards(str(tmp_path), n_hosts, str(tmp_path / "x.sela"))
    # recovery: run the missing rank, merge succeeds and matches single-host
    multihost.encode_shard(w, str(tmp_path), 1, n_hosts, chunk_frames=CHUNK,
                           device="cpu")
    multihost.merge_shards(str(tmp_path), n_hosts, str(tmp_path / "x.sela"))
    merged = open(tmp_path / "x.sela", "rb").read()
    assert merged == _encode(w)
    _assert_decodes_to(merged, w)


def test_corrupt_part_rejected(tmp_path, rng, signal_factory):
    w = make_long_wav(rng, signal_factory, n=2048 * 4)
    _shard_all(w, tmp_path, 2)
    p = tmp_path / "part-0001.selapart"
    data = bytearray(p.read_bytes())
    data[10] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(RuntimeError, match="checksum"):
        multihost.merge_shards(str(tmp_path), 2, str(tmp_path / "x.sela"))


def test_more_hosts_than_frames(tmp_path, rng, signal_factory):
    w = make_long_wav(rng, signal_factory, n=2048 * 2)  # 2 frames, 4 hosts
    _shard_all(w, tmp_path, 4)
    multihost.merge_shards(str(tmp_path), 4, str(tmp_path / "x.sela"))
    merged = open(tmp_path / "x.sela", "rb").read()
    assert merged == _encode(w)
    _assert_decodes_to(merged, w)


def test_manifest_throughput_counters(tmp_path, rng, signal_factory):
    """Shard manifests carry wall/throughput counters; merge aggregates them."""
    w = make_long_wav(rng, signal_factory, n=2048 * 4)
    for rank in range(2):
        m = multihost.encode_shard(w, str(tmp_path), rank, 2,
                                   chunk_frames=CHUNK, device="cpu")
        assert m["wall_s"] > 0
        assert m["pcm_bytes"] == 2048 * 2 * 2 * 2
        assert m["mb_per_s"] > 0
    info = multihost.merge_shards(str(tmp_path), 2, str(tmp_path / "m.sela"))
    assert 0 < info["balance"] <= 1.0
    assert info["aggregate_mb_per_s"] > 0
    assert info["wall_max_s"] >= info["wall_mean_s"]
    manifests = [
        json.load(open(tmp_path / f"part-{r:04d}.manifest.json")) for r in (0, 1)
    ]
    eff = multihost.scaling_efficiency(2 * info["wall_mean_s"], manifests)
    assert eff > 0
    assert eff == jax_multihost.scaling_efficiency(2 * info["wall_mean_s"],
                                                   manifests)


def test_manifest_keys_match_jax(tmp_path, rng, signal_factory):
    w = make_long_wav(rng, signal_factory, n=2048 * 3)
    ours = multihost.encode_shard(w, str(tmp_path / "port"), 0, 2,
                                  chunk_frames=CHUNK, device="cpu")
    theirs = jax_multihost.encode_shard(w, str(tmp_path / "jax"), 0, 2,
                                        chunk_frames=CHUNK)
    assert set(ours) == set(theirs)
    for key in ("rank", "n_hosts", "frame_lo", "frame_hi", "n_frames",
                "sample_rate", "bits_per_sample", "channels", "n_samples",
                "pcm_bytes"):
        assert ours[key] == theirs[key], key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parts_merge_identically_through_either_package(tmp_path, rng,
                                                        signal_factory, writer):
    """One package's parts, merged by both packages' merge_shards: the same
    bytes, one encode of the whole file by the writing package, decoding
    through the oracle to the input."""
    w = make_long_wav(rng, signal_factory)
    n_hosts = 3
    if writer == "port":
        _shard_all(w, tmp_path, n_hosts)
        single = _encode(w)
    else:
        for rank in range(n_hosts):
            jax_multihost.encode_shard(w, str(tmp_path), rank, n_hosts,
                                       chunk_frames=CHUNK)
        single = jax_encode_wav(w, chunk_frames=CHUNK)
    ours, theirs = tmp_path / "port.sela", tmp_path / "jax.sela"
    info = multihost.merge_shards(str(tmp_path), n_hosts, str(ours))
    jinfo = jax_multihost.merge_shards(str(tmp_path), n_hosts, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes() == single
    assert {k: v for k, v in info.items() if k != "path"} == {
        k: v for k, v in jinfo.items() if k != "path"}
    _assert_decodes_to(ours.read_bytes(), w)
