"""One rank of a multi-process shard encode, as its own OS process.

    python -m sela_tpu_torch.parallel.shard_worker <in.wav> <out_dir>
        [--rank R --n-hosts N] [--chunk-frames F] [--slow-ms N] [--device D]

Counterpart of tools/shard_worker.py. Without --rank/--n-hosts the rank and
the world size come from the torch.distributed environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK), through `multihost.init_distributed`'s gloo
rendezvous; with them, no group is joined (filesystem-only coordination,
e.g. to re-run one missing rank). The worker encodes its frame range of the
WAV with `multihost.encode_shard` and writes part, manifest and done
marker, then leaves the group.

Device: --device if given, else `cuda:(LOCAL_RANK % device_count)` when
LOCAL_RANK is set, else the current CUDA device; without CUDA it raises
unless --device cpu. --slow-ms sleeps that long after joining and before
encoding, a window in which a fault test can kill the rank. Once joined it
prints `joined rank R/N` to stderr; at the end one JSON line to stdout:
rank, frame range, bytes, sha256, `wall_s` (inside encode_shard: no import
of torch, no CUDA context, which the worker creates first, and no first
use, `first_use_s`: one frame of silence encoded before), the encode's
stage seconds and its kernel launches.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _device(arg: str | None):
    import torch

    if arg is not None:
        return arg
    if "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        return f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}"
    return None


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sela_tpu_torch.parallel.shard_worker",
        description="encode one rank's frame range of a WAV")
    ap.add_argument("input")
    ap.add_argument("out_dir")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--n-hosts", type=int, default=None)
    ap.add_argument("--chunk-frames", type=int, default=512)
    ap.add_argument("--slow-ms", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if (args.rank is None) != (args.n_hosts is None):
        ap.error("--rank and --n-hosts go together")

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..kernels import coeffs as k_lpc
    from ..kernels import encode as k_enc
    from ..kernels import iir as k_iir
    from ..codec.encoder import encode_wav
    from ..ref.wav import WavData, read_wav
    from ..utils.device import resolve_device
    from ..utils.metrics import Metrics
    from .multihost import encode_shard, init_distributed

    if args.rank is not None:
        rank, n_hosts = args.rank, args.n_hosts
    else:
        rank, n_hosts = init_distributed()
    try:
        print(f"joined rank {rank}/{n_hosts}", file=sys.stderr, flush=True)
        device = resolve_device(_device(args.device))
        if device.type == "cuda":   # the context, before encode_shard's clock
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)
        w = read_wav(args.input)
        # first use (kernel modules, pinned slots, allocator) outside
        # encode_shard's clock: one frame of silence of the input's shape
        t0 = time.perf_counter()
        encode_wav(WavData(w.sample_rate, w.bits_per_sample,
                           [np.zeros(1, np.int32)] * w.n_channels),
                   device=device)
        first_use_s = time.perf_counter() - t0
        if args.slow_ms:
            time.sleep(args.slow_ms / 1000.0)
        stages = Metrics()
        m = encode_shard(w, args.out_dir, rank, n_hosts,
                         chunk_frames=args.chunk_frames, device=device,
                         metrics=stages)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps({
        "rank": rank, "n_hosts": n_hosts, "frame_lo": m["frame_lo"],
        "frame_hi": m["frame_hi"], "bytes": m["bytes"], "sha256": m["sha256"],
        "wall_s": m["wall_s"], "first_use_s": round(first_use_s, 6),
        "device": str(device),
        "stages": {k: round(v, 4) for k, v in stages.stage_s.items()},
        "launches": {"lpc": k_lpc.launches, **k_enc.launches,
                     "iir": k_iir.launches}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
