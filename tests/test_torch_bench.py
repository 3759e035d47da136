"""The port's bench (sela_tpu_torch/bench.py) on the CPU at tiny sizes: its
corpora equal the JAX bench's, its pieces run and check their round trips,
and its result line parses, names the device and fits in 1,500 characters.
CPU times say nothing of the card; only the shape of the output is held."""
import json

import numpy as np
import pytest

from sela_tpu import bench as jax_bench
from sela_tpu_torch import bench
from sela_tpu_torch.ref.wav import WavData


@pytest.mark.parametrize("seconds,rate,seed,bits", [
    (0.5, 44100, 0, 16), (0.25, 96000, 1, 24), (0.2, 44100, 2, 32),
    (0.3, 22050, 107, 16)])
def test_make_corpus_equals_jax(seconds, rate, seed, bits):
    got = bench.make_corpus(seconds, rate=rate, seed=seed, bits=bits)
    want = jax_bench.make_corpus(seconds, rate=rate, seed=seed, bits=bits)
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_make_batch_equals_jax_batch64_files():
    """The first files of make_batch are those the JAX bench_batch64 builds
    (seed 11, 0.3-2.0 s, 22.05/44.1/48 kHz, 16/24-bit, mono/stereo)."""
    rng = np.random.default_rng(11)
    for i, w in enumerate(bench.make_batch(4)):
        secs = float(rng.uniform(0.3, 2.0))
        rate = int(rng.choice([22050, 44100, 48000]))
        bits = int(rng.choice([16, 16, 24]))
        nch = int(rng.choice([1, 2]))
        left, right = jax_bench.make_corpus(secs, rate=rate, seed=100 + i,
                                            bits=bits)
        assert (w.sample_rate, w.bits_per_sample, w.n_channels) == (rate, bits,
                                                                    nch)
        for a, b in zip(w.channels, [left, right][:nch]):
            np.testing.assert_array_equal(a, b)


def test_bench_e2e_and_host_pack_at_tiny_sizes():
    w = WavData(44100, 16, list(bench.make_corpus(0.1)))
    rec = bench.bench_e2e(w, iters=2, device="cpu")
    assert rec["bit_exact"] and 0 < rec["compression_ratio"] < 1
    assert rec["encode_s"] > 0 and rec["decode_s"] > 0
    hp = bench.bench_host_pack(n_blocks=8, n_vals=128, iters=2)
    assert hp["pack_mb_per_s"] > 0 and hp["count_s"] <= hp["pack_s"] * 10


def test_device_pack_and_pipeline_at_tiny_sizes():
    dp = bench.bench_device_pack(n_blocks=8, n_vals=128, iters=2,
                                 device="cpu")
    assert dp["byte_exact_vs_host"] and dp["device"] == "cpu"
    assert dp["fetch_bytes_host_pack"] == 8 * 128 * 2
    assert 0 < dp["payload_bytes"] <= dp["fetch_bytes_device_pack"]
    pipe = bench.bench_device_pipeline(0.1, chunk_frames=2, n_chunks=2,
                                       iters=1, device="cpu")
    assert pipe["bit_exact"] and pipe["pcm_mb_per_pass"] == 4 * 2 * 2048 * 2 / 1e6


def test_run_bench_prints_one_short_json_line(monkeypatch, capsys, tmp_path):
    """The whole run at tiny sizes: one JSON line on stdout of at most
    1,500 characters that names the device; the detail file holds every
    section."""
    real = (bench.make_batch, bench.bench_host_pack, bench.bench_device_pack,
            bench.bench_device_pipeline)
    monkeypatch.setattr(bench, "make_batch", lambda: [
        WavData(w.sample_rate, w.bits_per_sample, [c[:1500] for c in w.channels])
        for w in real[0](2)])
    monkeypatch.setattr(bench, "bench_host_pack",
                        lambda **kw: real[1](n_blocks=4, n_vals=64, **kw))
    monkeypatch.setattr(bench, "bench_device_pack",
                        lambda **kw: real[2](n_blocks=4, n_vals=64, **kw))
    monkeypatch.setattr(bench, "bench_device_pipeline",
                        lambda s, **kw: real[3](s, chunk_frames=1, n_chunks=2,
                                                **kw))
    detail = tmp_path / "detail.json"
    result = bench.run_bench(0.05, device="cpu", detail_path=str(detail),
                             iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) <= bench.LINE_MAX
    assert json.loads(lines[0]) == result
    assert result["device"] == {"name": "cpu", "power_limit": None}
    assert result["value"] > 0 and "vs_baseline" not in result
    sections = json.loads(detail.read_text())
    for key in ("e2e_cd", "e2e_cd_v2_encode", "e2e_hires", "e2e_32bit",
                "batch64", "host_pack", "device_pack", "device_pipeline"):
        assert key in sections, key
