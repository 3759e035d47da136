"""The port's CLI commands over the tags, the corpus batch codec, the
streaming player and the shard encode, on the CPU: `tag` writes the bytes
`selax tag` writes; `encode-batch`/`decode-batch` and `play --wav-out`
round-trip with --cpu; `encode-shard` for each rank then `merge-shards`
writes the bytes of `encode --cpu`, and a missing rank exits 3. The JAX
CLI's flags: `--engine ref` writes the JAX oracle's bytes, `--log-json`
emits the JAX stage timer's record, `--profile-trace DIR` writes a trace,
`-e`/`-d`/`-p` alias encode/decode/play, and a missing file, a malformed
WAV or `.sela` and a bad value exit 2 with a one-line message."""
import json

import numpy as np
import pytest

from sela_tpu import cli as jax_cli
from sela_tpu.ref import codec as jax_ref_codec
from sela_tpu.ref.wav import WavData as JaxWavData
from sela_tpu.utils.metrics import Metrics as JaxMetrics
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


@pytest.fixture
def wav_file(tmp_path, rng, signal_factory):
    n = 2048 * 2 + 300
    w = WavData(44100, 16, [signal_factory(rng, n, kind="ar"),
                            signal_factory(rng, n, kind="tone")])
    path = tmp_path / "in.wav"
    write_wav(str(path), w)
    return w, path


def test_engine_ref_writes_the_jax_oracles_bytes(wav_file, tmp_path, capsys):
    w, wav = wav_file
    out, back = tmp_path / "ref.sela", tmp_path / "back.wav"
    assert main(["encode", str(wav), str(out), "--engine", "ref",
                 "--tag", "k=v"]) == 0
    want = jax_ref_codec.encode_wav(JaxWavData(w.sample_rate,
                                               w.bits_per_sample, w.channels),
                                    tags={"k": "v"})
    assert out.read_bytes() == want
    assert main(["decode", str(out), str(back), "--engine", "ref"]) == 0
    assert main(["verify", str(wav), "--engine", "ref"]) == 0
    text = capsys.readouterr().out
    assert "engine=ref" in text and "BIT-EXACT" in text
    for a, b in zip(read_wav(str(back)).channels, w.channels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op", ["encode", "decode"])
def test_log_json_emits_the_jax_stage_timers_record(op, wav_file, tmp_path,
                                                    capsys):
    """One JSON line on stderr whose top-level keys are those of the JAX
    package's Metrics.snapshot given the same counters and stages, less its
    `mb_per_s` (PCM over the sum of stages, which nested stages and worker
    seconds make meaningless). Encode's stages include host_pack's spans
    and bitio's worker figures, and its record the port's own counters of
    the blocks bitio packed (pack_blocks_host: every block, on the CPU) and
    of the chunks encoded (chunks) and of those whose device step ran
    eagerly (step_eager: every chunk on the CPU), here one, and of the
    bytes framed into the chunk's slot (framed_bytes: each sample and pad
    once, on the int16 wire). Decode's stages include host_unpack's
    rice_unpack spans, and its record the chunks decoded (chunks), here
    one, and of those on the int32 wire (int32_wire_chunks), here none."""
    _, wav = wav_file
    sela = tmp_path / "in.sela"
    assert main(["encode", str(wav), str(sela), "--cpu"]) == 0
    src = wav if op == "encode" else sela
    capsys.readouterr()
    assert main([op, str(src), str(tmp_path / f"o.{op}"), "--cpu",
                 "--log-json"]) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["op"] == op and rec["frames"] == 3
    assert "mb_per_s" not in rec
    stages = {k[:-2] for k in rec if k.endswith("_s")}
    assert stages == ({"host_frame", "device_dispatch", "device_fetch",
                       "host_pack", "pack_gather", "rice_count", "rice_pack",
                       "emit", "bitio_workers", "bitio_workers_on_cpu"}
                      if op == "encode" else
                      {"host_parse", "host_unpack", "rice_unpack",
                       "device_dispatch", "device_fetch", "host_assemble"})
    counters = ("frames", "pcm_bytes", "coded_bytes", "chunks")
    assert rec["chunks"] == 1
    if op == "encode":
        assert rec["pack_blocks_host"] == 2 * 3 * 2
        assert rec["step_eager"] == 1
        assert rec["framed_bytes"] == 3 * 2 * 2048 * 2
        counters += ("pack_blocks_host", "step_eager", "framed_bytes")
    else:
        assert rec["int32_wire_chunks"] == 0
        counters += ("int32_wire_chunks",)
    m = JaxMetrics()
    for k in counters:
        m.count(k, rec[k])
    for name in stages:
        m.stage_s[name] = rec[f"{name}_s"]
        m.stage_n[name] = 1
    assert set(rec) == set(m.snapshot(op)) - {"mb_per_s"}


@pytest.mark.parametrize("op", ["encode", "decode"])
def test_profile_trace_writes_a_trace(op, wav_file, tmp_path):
    _, wav = wav_file
    sela = tmp_path / "in.sela"
    assert main(["encode", str(wav), str(sela), "--cpu"]) == 0
    src = wav if op == "encode" else sela
    trace_dir = tmp_path / "trace"
    assert main([op, str(src), str(tmp_path / "out"), "--cpu",
                 "--profile-trace", str(trace_dir)]) == 0
    files = list(trace_dir.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    # the program's stages are ranges of the trace
    stage = "stage:host_pack" if op == "encode" else "stage:host_unpack"
    assert any(e.get("name") == stage for e in events)


def test_short_aliases(wav_file, tmp_path, capsys):
    w, wav = wav_file
    sela, back = tmp_path / "a.sela", tmp_path / "b.wav"
    assert main(["-e", str(wav), str(sela), "--cpu"]) == 0
    assert main(["-d", str(sela), str(back), "--cpu"]) == 0
    assert main(["-p", str(sela), "--cpu", "--wav-out",
                 str(tmp_path / "p.wav")]) == 0
    text = capsys.readouterr().out
    assert "encoded" in text and "decoded" in text and "streamed" in text
    for a, b in zip(read_wav(str(back)).channels, w.channels):
        np.testing.assert_array_equal(a, b)


BAD_INPUTS = {
    "missing wav": (["encode", "{d}/none.wav", "{d}/o.sela"], "file not found"),
    "missing sela": (["decode", "{d}/none.sela", "{d}/o.wav"], "file not found"),
    "bad wav": (["encode", "{d}/bad.wav", "{d}/o.sela"], "RIFF"),
    "bad sela": (["decode", "{d}/bad.wav", "{d}/o.wav"], "error"),
    "bad value": (["encode", "{d}/in.wav", "{d}/o.sela", "--frame-size",
                   "5000"], "frame"),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_bad_input_exits_2_with_one_line(case, wav_file, tmp_path, capsys):
    (tmp_path / "bad.wav").write_bytes(b"RIFF\x04\x00\x00\x00JUNKJUNK")
    argv, message = BAD_INPUTS[case]
    assert main([a.format(d=tmp_path) for a in argv] + ["--cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and len(err.strip().splitlines()) == 1
    assert message in err
