"""Multi-process corpus encoding: frame-range shards and their ordered merge.

Counterpart of sela_tpu/parallel/multihost.py, whose shard and merge logic
is copied here (that module cannot be imported: its package imports jax).
Frames are stateless and the analysis is per frame, so

  * a long file splits into contiguous FRAME RANGES, one per rank;
  * each rank encodes its range with `encode_wav` (on its card unless told
    the CPU) and writes the serialized frames to `part-<rank>.selapart`, a
    JSON manifest (frame counts, byte sizes, sha256, wall) and a `.done`
    marker;
  * the merge concatenates the parts in rank order after the global
    header: the bytes of one `encode_wav` of the whole file;
  * recovery is re-running a rank whose `.done` marker is missing.

The file names and the manifest's keys are the JAX package's, so either
package's `merge_shards` merges either package's parts.

Encoded frames never cross processes: the only coordination is the
filesystem and, where the ranks come from the environment, the rendezvous
of `init_distributed` (torch.distributed over gloo).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from datetime import timedelta

from ..format import FRAME_SIZE
from ..ref import container
from ..ref.wav import WavData

RENDEZVOUS_TIMEOUT_S = 60   # a peer that never joins fails the others


def init_distributed() -> tuple[int, int]:
    """Join the process group from the standard torch.distributed
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun
    sets them), over gloo: only the rendezvous crosses processes, the parts
    go through the filesystem. Returns (rank, world_size), or (0, 1)
    without MASTER_ADDR. Raises if a peer has not joined within
    RENDEZVOUS_TIMEOUT_S (gloo's own default is 30 minutes). Leave with
    `torch.distributed.destroy_process_group()`."""
    if not os.environ.get("MASTER_ADDR"):
        return 0, 1
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return dist.get_rank(), dist.get_world_size()


def frame_ranges(n_samples: int, n_hosts: int, frame_size: int = FRAME_SIZE):
    """Contiguous frame ranges [(lo, hi)) per host; near-equal sizes."""
    n_frames = -(-n_samples // frame_size)
    base = n_frames // n_hosts
    extra = n_frames % n_hosts
    ranges = []
    lo = 0
    for h in range(n_hosts):
        hi = lo + base + (1 if h < extra else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


def _part_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"part-{rank:04d}.selapart")


def _manifest_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"part-{rank:04d}.manifest.json")


def _done_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"part-{rank:04d}.done")


def encode_shard(w: WavData, out_dir: str, rank: int, n_hosts: int,
                 chunk_frames: int = 512, frame_size: int = FRAME_SIZE,
                 device=None, metrics=None) -> dict:
    """Encode this rank's frame range of `w` on `device` (default: the CUDA
    card; raises without one unless device="cpu") and write part +
    manifest + done marker. metrics: optional utils.metrics.Metrics sink
    of the encode's stages."""
    from ..codec.encoder import encode_wav
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    lo, hi = frame_ranges(w.n_samples, n_hosts, frame_size)[rank]
    s_lo = lo * frame_size
    s_hi = min(hi * frame_size, w.n_samples)
    shard = WavData(
        w.sample_rate, w.bits_per_sample, [c[s_lo:s_hi] for c in w.channels]
    )
    t0 = time.perf_counter()
    if s_hi > s_lo:
        buf = encode_wav(shard, frame_size=frame_size,
                         chunk_frames=chunk_frames, metrics=metrics,
                         device=dev)
        frames_bytes = buf[container.HEADER_SIZE :]  # strip the shard header
        n_frames = container.parse_header(buf).num_frames
    else:
        frames_bytes = b""
        n_frames = 0
    wall_s = time.perf_counter() - t0
    pcm_bytes = (s_hi - s_lo) * w.n_channels * w.bits_per_sample // 8
    with open(_part_path(out_dir, rank), "wb") as f:
        f.write(frames_bytes)
    manifest = {
        "rank": rank,
        "n_hosts": n_hosts,
        "frame_lo": lo,
        "frame_hi": hi,
        "n_frames": n_frames,
        "bytes": len(frames_bytes),
        "sha256": hashlib.sha256(frames_bytes).hexdigest(),
        "sample_rate": w.sample_rate,
        "bits_per_sample": w.bits_per_sample,
        "channels": w.n_channels,
        "n_samples": w.n_samples,
        # per-shard throughput for the merge's balance and scaling figures
        "wall_s": round(wall_s, 6),
        "pcm_bytes": pcm_bytes,
        "mb_per_s": round(pcm_bytes / wall_s / 1e6, 3) if wall_s > 0 else 0.0,
    }
    with open(_manifest_path(out_dir, rank), "w") as f:
        json.dump(manifest, f)
    with open(_done_path(out_dir, rank), "w") as f:
        f.write("ok\n")
    return manifest


def scaling_efficiency(single_host_wall_s: float, manifests: list[dict]) -> float:
    """Strong-scaling efficiency T_1 / (N * T_N), T_N the slowest shard's
    wall (the corpus completes when the last rank does)."""
    t_n = max(m["wall_s"] for m in manifests)
    return single_host_wall_s / (len(manifests) * t_n) if t_n > 0 else 0.0


def missing_shards(out_dir: str, n_hosts: int) -> list[int]:
    """Ranks whose done-marker (or part/manifest) is absent — re-run these."""
    out = []
    for rank in range(n_hosts):
        if not (
            os.path.exists(_done_path(out_dir, rank))
            and os.path.exists(_part_path(out_dir, rank))
            and os.path.exists(_manifest_path(out_dir, rank))
        ):
            out.append(rank)
    return out


def merge_shards(out_dir: str, n_hosts: int, out_path: str) -> dict:
    """Rank-ordered concatenation of parts into one bit-exact container."""
    missing = missing_shards(out_dir, n_hosts)
    if missing:
        raise RuntimeError(f"missing shards: {missing} — re-run encode_shard")
    manifests = []
    for rank in range(n_hosts):
        with open(_manifest_path(out_dir, rank)) as f:
            manifests.append(json.load(f))
    m0 = manifests[0]
    total_frames = sum(m["n_frames"] for m in manifests)
    header = container.SelaHeader(
        m0["sample_rate"], m0["bits_per_sample"], m0["channels"], total_frames
    )
    with open(out_path, "wb") as out:
        out.write(container.serialize_file(header, []))
        for rank, m in enumerate(manifests):
            with open(_part_path(out_dir, rank), "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != m["sha256"]:
                raise RuntimeError(f"shard {rank}: checksum mismatch — corrupt part")
            out.write(data)
    info = {"frames": total_frames, "hosts": n_hosts, "path": out_path}
    walls = [m.get("wall_s", 0.0) for m in manifests]
    if all(t > 0 for t in walls):
        total_pcm = sum(m.get("pcm_bytes", 0) for m in manifests)
        # balance = 1.0 means perfectly even shard times
        info["wall_max_s"] = round(max(walls), 6)
        info["wall_mean_s"] = round(sum(walls) / len(walls), 6)
        info["balance"] = round(info["wall_mean_s"] / info["wall_max_s"], 4)
        info["aggregate_mb_per_s"] = round(total_pcm / max(walls) / 1e6, 3)
    return info
