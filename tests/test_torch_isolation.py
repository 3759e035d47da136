"""The PyTorch port stands alone: it imports nothing of JAX or the JAX package,
and its entry points never fall back to the CPU without being asked."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sela_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "sela_tpu")


def _port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


ENCODE_MODULES = ("config.py", "codec/encoder.py", "codec/pipeline.py",
                  "kernels/encode.py", "ops/analysis.py", "ops/filters.py",
                  "ops/rice.py", "native/bitio.py", "cli.py", "bench.py",
                  "codec/corpus.py", "codec/stream.py", "kernels/pack.py",
                  "ops/pack.py", "utils/bitpack.py", "parallel/mesh.py",
                  "parallel/multihost.py", "parallel/shard_worker.py",
                  "ops/chain.py", "kernels/chain.py", "tools/__init__.py",
                  "tools/_common.py", "tools/roofline.py",
                  "tools/profile_stages.py", "tools/sweep_kernels.py",
                  "tools/sweep_ratio.py", "tools/measure_scaling.py",
                  "tools/check_regression.py")


def test_port_sources_import_no_jax():
    sources = _port_sources()
    assert len(sources) > 20
    rel = {os.path.relpath(p, PORT).replace(os.sep, "/") for p in sources}
    assert set(ENCODE_MODULES) <= rel
    bad = {os.path.relpath(p, REPO): sorted(n for n in _imported(p) if _forbidden(n))
           for p in sources}
    assert not {p: n for p, n in bad.items() if n}


def test_port_modules_load_with_jax_blocked():
    """Import every port module in a fresh interpreter in which importing
    jax, jaxlib or sela_tpu raises."""
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources() if p.startswith(PORT))
    code = f"""
import importlib, importlib.abc, sys
BLOCK = {FORBIDDEN!r}
for name in list(sys.modules):
    if any(name == b or name.startswith(b + ".") for b in BLOCK):
        del sys.modules[name]
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCK):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Blocker())
for m in {modules!r}:
    importlib.import_module(m)
print("ok", len({modules!r}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_decode_without_device_raises_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    from sela_tpu_torch.codec.decoder import decode_sela
    from sela_tpu_torch.ref import codec as ref_codec
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(0)
    buf = ref_codec.encode_wav(
        WavData(44100, 16, [rng.integers(-900, 900, 500).astype(np.int32)]))
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_sela(buf)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_sela(buf, device="cuda")
    assert decode_sela(buf, device="cpu").n_samples == 500


def test_encode_without_device_raises_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    from sela_tpu_torch.codec.encoder import encode_wav
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(0)
    w = WavData(44100, 16, [rng.integers(-900, 900, 500).astype(np.int32)])
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_wav(w)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_wav(w, device="cuda")
    assert encode_wav(w, device="cpu")[:4] == b"SeLa"


def _no_cuda_clip():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    from sela_tpu_torch.ref.wav import WavData

    rng = np.random.default_rng(0)
    return WavData(44100, 16, [rng.integers(-900, 900, 500).astype(np.int32)])


def test_corpus_without_device_raises_on_cuda_less_host():
    from sela_tpu_torch.codec.corpus import decode_files, encode_files

    w = _no_cuda_clip()
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            encode_files([w], device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            encode_files([w], frame_size=100, device=device)
    assert encode_files([w], frame_size=100, device="cpu")[0][:4] == b"SeLa"
    bufs = encode_files([w], device="cpu")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            decode_files(bufs, device=device)
    assert decode_files(bufs, device="cpu")[0].n_samples == 500


def test_stream_without_device_raises_on_cuda_less_host():
    from sela_tpu_torch.codec.stream import StreamingPlayer, decode_stream
    from sela_tpu_torch.ref import codec as ref_codec

    buf = ref_codec.encode_wav(_no_cuda_clip())
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            next(decode_stream(buf, device=device))
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingPlayer(buf, device=device)
    assert len(next(decode_stream(buf, device="cpu"))) == 500


def test_bench_without_device_raises_on_cuda_less_host():
    from sela_tpu_torch.bench import run_bench

    _no_cuda_clip()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bench(0.01)


def test_parallel_without_device_raises_on_cuda_less_host(tmp_path):
    """data_mesh(), encode_shard and the shard worker default to the card;
    data_mesh never falls back to the CPU."""
    from sela_tpu_torch.parallel import mesh, multihost, shard_worker
    from sela_tpu_torch.ref.wav import write_wav

    w = _no_cuda_clip()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.data_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.data_mesh(devices=["cuda:0"] * 2)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            multihost.encode_shard(w, str(tmp_path / "s"), 0, 2, device=device)
    assert not (tmp_path / "s").exists()   # nothing written before raising
    wav = str(tmp_path / "in.wav")
    write_wav(wav, w)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_worker.main([wav, str(tmp_path / "s"), "--rank", "0",
                           "--n-hosts", "1"])
    assert multihost.encode_shard(w, str(tmp_path / "s"), 0, 1,
                                  device="cpu")["n_frames"] == 1


TOOL_CALLS = {
    "roofline": ("roofline", []),
    "profile_stages": ("profile_stages", ["4", "--only", "transpose_BN"]),
    "sweep_kernels": ("sweep_kernels", ["4"]),
    "sweep_ratio": ("sweep_ratio", ["--seconds", "1"]),
    "measure_scaling": ("measure_scaling", ["--seconds", "1", "--ranks", "2"]),
}


@pytest.mark.parametrize("tool", list(TOOL_CALLS))
def test_tools_without_cpu_raise_on_cuda_less_host(tool, tmp_path,
                                                   monkeypatch):
    """Each timing tool runs on the card unless given --cpu: without a card
    it raises before it measures or writes anything."""
    import importlib

    _no_cuda_clip()
    monkeypatch.chdir(tmp_path)
    module, argv = TOOL_CALLS[tool]
    main = importlib.import_module(f"sela_tpu_torch.tools.{module}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert os.listdir(tmp_path) == []


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py exits non-zero and prints no result line when the host
    has no card."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
