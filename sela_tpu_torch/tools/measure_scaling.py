"""Measure the shard encode's scaling over processes pinned to equal cores.

    python -m sela_tpu_torch.tools.measure_scaling [--seconds 48] [--ranks 2,4]
        [--chunk-frames 256] [--cores-per-host K] [--cpu] [--out PATH]

Counterpart of tools/measure_scaling.py. Drives N-rank shard encodes as
separate OS processes (`parallel/shard_worker.py` with --rank and
--n-hosts: no rendezvous, filesystem coordination) and computes
`parallel.multihost.scaling_efficiency()`, T1 / (N max(T_shard)), from the
manifests' `wall_s` against a single-rank run. Every process, the baseline
and the shards, is pinned with `taskset` to the same number of cores, so
each "host" gets equal host compute; when the machine has fewer cores than
the ranks need, the ranks run one after another (each still pinned), and
the record says which mode produced each number. On the card all ranks
share one GPU: this measures the host-bound encode's scaling in processes,
not multi-host scaling.

Before any efficiency is reported, every merged N-rank container must have
the sha256 of the single rank's; a mismatch raises. Prints one JSON line
on stdout (written to PATH only with --out) and exits 1 when the worst
efficiency is below 0.80, as the JAX tool does. --cpu passes `--device cpu`
to the workers (the plain versions). The JAX tool's JAX_PLATFORMS=cpu and
its compile-cache warm-up run have no counterpart beyond one warm-up rank:
nothing is compiled but the kernel libraries, which it builds.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

from ..utils.device import resolve_device
from ._common import REPO, device_record, emit


def _run_rank(wav: str, out_dir: str, rank: int, n_hosts: int,
              chunk_frames: int, cores: list[int], cpu: bool) -> subprocess.Popen:
    cmd = ["taskset", "-c", ",".join(map(str, cores)), sys.executable, "-m",
           "sela_tpu_torch.parallel.shard_worker", wav, out_dir,
           "--rank", str(rank), "--n-hosts", str(n_hosts),
           "--chunk-frames", str(chunk_frames),
           *(["--device", "cpu"] if cpu else [])]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def _wait(p: subprocess.Popen, what: str) -> None:
    _, err = p.communicate()
    if p.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {p.returncode}):\n{err[-2000:]}")


def _manifests(out_dir: str, n_hosts: int) -> list[dict]:
    out = []
    for rank in range(n_hosts):
        with open(os.path.join(out_dir, f"part-{rank:04d}.manifest.json")) as f:
            out.append(json.load(f))
    return out


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def measure(seconds: float = 48.0, ranks=(2, 4), chunk_frames: int = 256,
            cores_per_host: int | None = None, cpu: bool = False) -> dict:
    from ..bench import make_corpus
    from ..parallel.multihost import merge_shards, scaling_efficiency
    from ..ref.wav import WavData, write_wav

    dev = resolve_device("cpu" if cpu else None)
    ncores = os.cpu_count() or 1
    cores_per_host = cores_per_host or max(1, ncores // max(ranks))
    results = {"device": device_record(dev), "cores_per_host": cores_per_host,
               "machine_cores": ncores, "chunk_frames": chunk_frames,
               "runs": {}}
    with tempfile.TemporaryDirectory(prefix="sela-scaling-") as tmp:
        wav = os.path.join(tmp, "corpus.wav")
        left, right = make_corpus(seconds, seed=5)
        write_wav(wav, WavData(44100, 16, [left, right]))
        pcm_mb = len(left) * 2 * 2 / 1e6
        base = list(range(cores_per_host))
        # one throwaway rank first: it builds the kernel libraries, so that
        # no measured rank pays for a build
        _wait(_run_rank(wav, os.path.join(tmp, "warm"), 0, 1, chunk_frames,
                        base, cpu), "the warm-up rank")
        d1 = os.path.join(tmp, "n1")
        _wait(_run_rank(wav, d1, 0, 1, chunk_frames, base, cpu),
              "the baseline rank")
        t1 = _manifests(d1, 1)[0]["wall_s"]
        single = os.path.join(tmp, "single.sela")
        merge_shards(d1, 1, single)
        ref_sha = _sha256(single)
        print(f"[scaling] baseline T1={t1:.3f}s on {cores_per_host} core(s), "
              f"{pcm_mb:.1f} MB PCM ({pcm_mb / t1:.1f} MB/s)", file=sys.stderr)
        results.update(pcm_mb=pcm_mb, t1_s=t1, sha256=ref_sha)
        for n in ranks:
            d = os.path.join(tmp, f"n{n}")
            concurrent = n * cores_per_host <= ncores
            procs = []
            for rank in range(n):
                cores = [(rank * cores_per_host + i) % ncores
                         for i in range(cores_per_host)]
                p = _run_rank(wav, d, rank, n, chunk_frames, cores, cpu)
                if concurrent:
                    procs.append((rank, p))
                else:
                    _wait(p, f"rank {rank}/{n}")
            for rank, p in procs:
                _wait(p, f"rank {rank}/{n}")
            ms = _manifests(d, n)
            merged = os.path.join(tmp, f"merged-n{n}.sela")
            info = merge_shards(d, n, merged)
            if _sha256(merged) != ref_sha:
                raise RuntimeError(f"the {n}-rank merge is not byte-identical "
                                   "to the single rank's")
            eff = scaling_efficiency(t1, ms)
            results["runs"][str(n)] = {
                "efficiency": eff,
                "mode": "concurrent" if concurrent else "sequential",
                "wall_s": [m["wall_s"] for m in ms],
                "balance": info.get("balance"), "bit_exact_merge": True,
            }
            print(f"[scaling] N={n} ({results['runs'][str(n)]['mode']}): "
                  f"efficiency={eff:.3f}, walls="
                  f"{results['runs'][str(n)]['wall_s']}", file=sys.stderr)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sela_tpu_torch.tools.measure_scaling",
        description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=48.0)
    ap.add_argument("--ranks", default="2,4")
    ap.add_argument("--chunk-frames", type=int, default=256)
    ap.add_argument("--cores-per-host", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="workers on the CPU (--device cpu)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON line here")
    args = ap.parse_args(argv)
    ranks = [int(r) for r in args.ranks.split(",")]
    results = measure(args.seconds, ranks, args.chunk_frames,
                      args.cores_per_host, args.cpu)
    emit(results, args.out)
    worst = min(r["efficiency"] for r in results["runs"].values())
    return 0 if worst >= 0.80 else 1


if __name__ == "__main__":
    sys.exit(main())
