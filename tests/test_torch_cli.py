"""The port's CLI commands over the tags, the corpus batch codec, the
streaming player and the shard encode, on the CPU: `tag` writes the bytes
`selax tag` writes; `encode-batch`/`decode-batch` and `play --wav-out`
round-trip with --cpu; `encode-shard` for each rank then `merge-shards`
writes the bytes of `encode --cpu`, and a missing rank exits 3."""
import numpy as np
import pytest

from sela_tpu import cli as jax_cli
from sela_tpu_torch.cli import main
from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.ref.wav import WavData, read_wav, write_wav

TAG_EDITS = {
    "read": [],
    "set": ["--set", "artist=A", "--set", "title=T é"],
    "clear": ["--clear", "--set", "only=x"],
    "apev2": ["--set", "album=B", "--format", "apev2"],
}


@pytest.fixture
def sela_file(tmp_path, rng, signal_factory):
    n = 2048 + 300
    w = WavData(44100, 16, [signal_factory(rng, n, kind="ar"),
                            signal_factory(rng, n, kind="tone")])
    path = tmp_path / "in.sela"
    path.write_bytes(encode_wav(w, device="cpu", tags={"genre": "g"}))
    return w, path


@pytest.mark.parametrize("edit", list(TAG_EDITS))
def test_tag_writes_the_bytes_selax_tag_writes(sela_file, tmp_path,
                                               monkeypatch, capsys, edit):
    monkeypatch.setenv("SELA_CACHE_DIR", str(tmp_path / "jax_cache"))
    _, src = sela_file
    ours, theirs = tmp_path / "ours.sela", tmp_path / "theirs.sela"
    flags = TAG_EDITS[edit] + (["--output"] if TAG_EDITS[edit] else [])
    assert main(["tag", str(src), *flags, *([str(ours)] if flags else [])]) == 0
    out_ours = capsys.readouterr().out
    assert jax_cli.main(["tag", str(src), *flags,
                         *([str(theirs)] if flags else [])]) == 0
    out_theirs = capsys.readouterr().out
    if flags:
        assert ours.read_bytes() == theirs.read_bytes()
        out_ours, out_theirs = (o.replace(str(p), "OUT") for o, p in
                                ((out_ours, ours), (out_theirs, theirs)))
    assert out_ours == out_theirs
    if edit == "read":
        assert "genre = g" in out_ours


def test_encode_batch_and_decode_batch_round_trip(tmp_path, rng, signal_factory,
                                                  capsys):
    paths, wavs = [], []
    for i, (nch, bits) in enumerate([(1, 16), (2, 24), (2, 16)]):
        n = int(rng.integers(600, 4000))
        w = WavData(48000, bits, [signal_factory(rng, n, amp=3000, kind="ar")
                                  for _ in range(nch)])
        paths.append(str(tmp_path / f"f{i}.wav"))
        write_wav(paths[-1], w)
        wavs.append(w)
    enc, dec = tmp_path / "enc", tmp_path / "dec"
    assert main(["encode-batch", *paths, str(enc), "--cpu",
                 "--chunk-frames", "2"]) == 0
    selas = [str(enc / f"f{i}.sela") for i in range(3)]
    for w, p in zip(wavs, selas):   # each the file's own stream
        with open(p, "rb") as f:
            assert f.read() == encode_wav(w, device="cpu")
    assert main(["decode-batch", *selas, str(dec), "--cpu"]) == 0
    assert "decoded 3 files" in capsys.readouterr().out
    for i, w in enumerate(wavs):
        back = read_wav(str(dec / f"f{i}.wav"))
        assert back.bits_per_sample == w.bits_per_sample
        for a, b in zip(back.channels, w.channels):
            np.testing.assert_array_equal(a, b)


def test_play_wav_out_round_trip(sela_file, tmp_path, capsys):
    w, src = sela_file
    out = tmp_path / "played.wav"
    assert main(["play", str(src), "--cpu", "--chunk-frames", "1",
                 "--wav-out", str(out)]) == 0
    assert "streamed" in capsys.readouterr().out
    back = read_wav(str(out))
    for a, b in zip(back.channels, w.channels):
        np.testing.assert_array_equal(a, b)
    src.write_bytes(src.read_bytes()[:-3])   # damage reaches the player
    assert main(["play", str(src), "--cpu"]) == 2


@pytest.mark.parametrize("n_hosts", [1, 3])
def test_encode_shard_then_merge_shards_equals_encode(tmp_path, rng,
                                                      signal_factory, capsys,
                                                      n_hosts):
    n = 2048 * 4 + 300
    w = WavData(44100, 16, [signal_factory(rng, n, kind="ar"),
                            signal_factory(rng, n, kind="tone")])
    wav, shards = str(tmp_path / "in.wav"), str(tmp_path / "shards")
    write_wav(wav, w)
    for rank in range(n_hosts):
        assert main(["encode-shard", wav, shards, "--rank", str(rank),
                     "--n-hosts", str(n_hosts), "--cpu",
                     "--chunk-frames", "2"]) == 0
    assert f"shard {n_hosts - 1}/{n_hosts}" in capsys.readouterr().out
    merged, single = tmp_path / "merged.sela", tmp_path / "single.sela"
    assert main(["merge-shards", shards, str(merged), "--n-hosts",
                 str(n_hosts)]) == 0
    assert main(["encode", wav, str(single), "--cpu"]) == 0
    assert merged.read_bytes() == single.read_bytes()


def test_merge_shards_with_a_missing_rank_exits_3(tmp_path, rng,
                                                  signal_factory, capsys):
    w = WavData(44100, 16, [signal_factory(rng, 2048 * 3, kind="ar")])
    wav, shards = str(tmp_path / "in.wav"), str(tmp_path / "shards")
    write_wav(wav, w)
    for rank in (0, 2):
        assert main(["encode-shard", wav, shards, "--rank", str(rank),
                     "--n-hosts", "3", "--cpu"]) == 0
    out = tmp_path / "merged.sela"
    assert main(["merge-shards", shards, str(out), "--n-hosts", "3"]) == 3
    assert "missing shards [1]" in capsys.readouterr().err
    assert not out.exists()
