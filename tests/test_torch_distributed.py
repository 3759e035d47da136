"""Real multi-process shard encodes of the port on the CPU, as
tests/test_distributed.py runs the JAX package's: two OS processes of
`python -m sela_tpu_torch.parallel.shard_worker` join one torch.distributed
group over gloo on 127.0.0.1 (`multihost.init_distributed`), encode disjoint
frame ranges, and the rank-ordered merge equals one `encode_wav` of the
file. Fault injection: kill one rank after it has joined the group; the
other still writes its shard and exits 0, the missing rank is named, and
re-running it alone converges to the same bytes."""
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from sela_tpu_torch.codec.encoder import encode_wav
from sela_tpu_torch.parallel import multihost
from sela_tpu_torch.ref.wav import WavData, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(extra)
    return env


def _spawn(wav, out, rank=None, n=2, port=None, extra=()):
    """One worker on the CPU: in the gloo group when port is given, else
    with an explicit --rank."""
    args = ["--rank", str(rank), "--n-hosts", str(n)] if port is None else []
    env = (_env() if port is None else
           _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(n), RANK=str(rank)))
    return subprocess.Popen(
        [sys.executable, "-m", "sela_tpu_torch.parallel.shard_worker", wav,
         out, "--device", "cpu", "--chunk-frames", "2", *args, *extra],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish(p) -> dict:
    out, err = p.communicate(timeout=WAIT_S)
    assert p.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def _wait_joined(p) -> threading.Thread:
    """Read the worker's stderr on a thread until it says it joined the
    group; the thread drains the rest until the worker exits."""
    lines = queue.Queue()

    def drain():
        for line in p.stderr:
            lines.put(line)
        lines.put("")

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    deadline = time.monotonic() + WAIT_S
    while True:
        line = lines.get(timeout=max(deadline - time.monotonic(), 0.01))
        if line.startswith("joined rank"):
            return reader
        assert line, "worker exited before joining"


def make_wav(rng, signal_factory, n=2048 * 4 + 200):
    return WavData(
        44100, 16,
        [signal_factory(rng, n, kind="ar"), signal_factory(rng, n, kind="tone")],
    )


@pytest.fixture
def wav(tmp_path, rng, signal_factory):
    w = make_wav(rng, signal_factory)
    path = str(tmp_path / "in.wav")
    write_wav(path, w)
    return w, path


def test_two_process_shard_encode_bit_exact(tmp_path, wav):
    w, wav_path = wav
    out_dir = str(tmp_path / "shards")
    port = _free_port()
    procs = [_spawn(wav_path, out_dir, r, 2, port) for r in range(2)]
    lines = [_finish(p) for p in procs]
    assert [(d["rank"], d["n_hosts"]) for d in lines] == [(0, 2), (1, 2)]
    assert [(d["frame_lo"], d["frame_hi"]) for d in lines] == \
        multihost.frame_ranges(w.n_samples, 2)
    assert all(d["device"] == "cpu" and d["wall_s"] > 0 for d in lines)
    assert multihost.missing_shards(out_dir, 2) == []
    merged_path = str(tmp_path / "merged.sela")
    multihost.merge_shards(out_dir, 2, merged_path)
    assert open(merged_path, "rb").read() == encode_wav(w, chunk_frames=8,
                                                        device="cpu")


def test_fault_injection_kill_and_recover(tmp_path, wav):
    """Kill rank 1 (SIGKILL, exact PID) after it has joined the group and
    while it sleeps before encoding: rank 0 still writes its shard and
    exits 0; the manifest layer reports rank 1 missing, and re-running only
    that rank converges to the bytes of the unfaulted run."""
    w, wav_path = wav
    out_dir = str(tmp_path / "shards")
    port = _free_port()
    p0 = _spawn(wav_path, out_dir, 0, 2, port)
    p1 = _spawn(wav_path, out_dir, 1, 2, port, extra=("--slow-ms", "60000"))
    try:
        reader = _wait_joined(p1)
    finally:
        os.kill(p1.pid, signal.SIGKILL)   # exact PID, never a pattern
        p1.wait(timeout=WAIT_S)
    reader.join(timeout=WAIT_S)
    p1.stdout.close()
    p1.stderr.close()
    _finish(p0)

    missing = multihost.missing_shards(out_dir, 2)
    assert missing == [1], f"expected rank 1 missing, got {missing}"
    with pytest.raises(RuntimeError, match="missing shards"):
        multihost.merge_shards(out_dir, 2, str(tmp_path / "x.sela"))

    # recovery: re-run the dead rank only, outside any group
    _finish(_spawn(wav_path, out_dir, 1, 2))
    assert multihost.missing_shards(out_dir, 2) == []
    merged_path = str(tmp_path / "merged.sela")
    multihost.merge_shards(out_dir, 2, merged_path)
    merged = open(merged_path, "rb").read()
    assert merged == encode_wav(w, chunk_frames=8, device="cpu")
    from sela_tpu_torch.codec.decoder import decode_sela

    back = decode_sela(merged, device="cpu")
    for a, b in zip(back.channels, w.channels):
        np.testing.assert_array_equal(a, b)
