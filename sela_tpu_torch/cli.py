"""Command-line interface of the PyTorch/CUDA port.

    python -m sela_tpu_torch.cli encode in.wav out.sela [--cpu] [profile flags]
                                        [--tag KEY=VALUE ...] [--engine E]
                                        [--log-json] [--profile-trace DIR]
    python -m sela_tpu_torch.cli decode in.sela out.wav [--cpu] [--chunk-frames N]
                                        [--engine E] [--log-json]
                                        [--profile-trace DIR]
    python -m sela_tpu_torch.cli verify in.wav [--cpu] [profile flags] [--engine E]
    python -m sela_tpu_torch.cli info file.sela
    python -m sela_tpu_torch.cli tag file.sela [--set KEY=VALUE ...] [--clear]
                                     [--format setg|apev2] [--output PATH]
    python -m sela_tpu_torch.cli play file.sela [--cpu] [--wav-out out.wav]
    python -m sela_tpu_torch.cli encode-batch a.wav b.wav ... out_dir [--cpu]
    python -m sela_tpu_torch.cli decode-batch a.sela b.sela ... out_dir [--cpu]
    python -m sela_tpu_torch.cli bench [--seconds S] [--cpu] [--detail PATH]
    python -m sela_tpu_torch.cli encode-shard in.wav shard_dir [--rank R]
                                              [--n-hosts N] [--cpu]
    python -m sela_tpu_torch.cli merge-shards shard_dir out.sela --n-hosts N

`encode`, `decode`, `verify`, `play`, the batch commands, `encode-shard`
and `bench` run on the CUDA card unless --cpu is given (then the plain
PyTorch versions of the kernels run); `info`, `tag` and `merge-shards` are
host-only. `encode-shard` without --rank takes its rank and the number of
ranks from the torch.distributed environment (MASTER_ADDR, WORLD_SIZE,
RANK); `merge-shards` exits 3 naming the ranks whose parts are missing. Profile flags:
--frame-size, --max-order, --rice-k-max, --no-mid-side, --exact-mid-side,
--partition-residues (the v2 profile). `encode --tag KEY=VALUE`
(repeatable) appends a tags trailer. `--engine ref` (encode, decode,
verify) runs the port's numpy oracle (`ref/codec.py`) in place of the
device codec; `--log-json` (encode, decode) writes one JSON-lines metrics
record to stderr; `--profile-trace DIR` (encode, decode) writes a
torch.profiler trace (CPU and CUDA activities, the stages as `stage:<name>`
ranges) into DIR. `-e`, `-d` and `-p` stand for encode, decode and play. A
missing file, a malformed WAV or `.sela` and a bad value exit 2 with a
one-line message. The JAX CLI's `decode --iir` has no counterpart: one IIR
kernel serves K2's and K7's contracts, chosen by the device. The `selax`
entry point of the JAX package is separate and unchanged.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _human(nbytes: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if nbytes < 1024:
            return f"{nbytes:.1f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.1f} TB"


def _profile_from(args):
    """BitstreamProfile from the profile flags (FORMAT.md v1 defaults)."""
    from .config import BitstreamProfile
    from .format import RESIDUE_PARTS

    return BitstreamProfile(
        frame_size=(BitstreamProfile.frame_size if args.frame_size is None
                    else args.frame_size),
        max_order=(BitstreamProfile.max_order if args.max_order is None
                   else args.max_order),
        rice_k_max=(BitstreamProfile.rice_k_max if args.rice_k_max is None
                    else args.rice_k_max),
        mid_side=("off" if args.no_mid_side
                  else "exact" if args.exact_mid_side else "auto"),
        residue_partition=RESIDUE_PARTS if args.partition_residues else 1,
    ).validate()


def _parse_tags(pairs: list[str]) -> dict:
    """KEY=VALUE strings -> {KEY: VALUE}."""
    tags = {}
    for kv in pairs:
        if "=" not in kv:
            raise ValueError(f"tag must be KEY=VALUE, got {kv!r}")
        k, v = kv.split("=", 1)
        tags[k] = v
    return tags


def _device(args):
    return "cpu" if args.cpu else None


def _metrics_from(args):
    """A sink for --log-json's record, and for --profile-trace's stage
    ranges."""
    from .utils.metrics import NULL_METRICS, Metrics

    return Metrics() if args.log_json or args.profile_trace else NULL_METRICS


def _engine(args) -> str:
    """What ran: the oracle, or the device codec on its device."""
    if args.engine == "ref":
        return "engine=ref"
    return f"device={'cpu' if args.cpu else 'cuda'}"


def cmd_encode(args) -> int:
    from .ref.wav import read_wav
    from .utils.metrics import profiler_trace

    w = read_wav(args.input)
    profile = _profile_from(args)
    tags = _parse_tags(args.tags or [])
    m = _metrics_from(args)
    t0 = time.perf_counter()
    with profiler_trace(args.profile_trace):
        if args.engine == "ref":
            from .ref.codec import encode_wav

            buf = encode_wav(w, profile=profile, tags=tags)
        else:
            from .codec.encoder import encode_wav

            buf = encode_wav(w, chunk_frames=args.chunk_frames,
                             profile=profile, metrics=m, tags=tags,
                             device=_device(args))
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(buf)
    if args.log_json:
        m.emit("encode")
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(
        f"encoded {args.input}: {_human(raw)} -> {_human(len(buf))} "
        f"(ratio {len(buf) / raw:.3f}) in {dt:.2f}s [{_human(raw / dt)}/s, "
        f"{_engine(args)}]"
    )
    return 0


def cmd_verify(args) -> int:
    """Encode, decode, and check that the PCM comes back bit for bit."""
    from .codec.decoder import decode_sela
    from .codec.encoder import encode_wav
    from .ref.wav import read_wav

    w = read_wav(args.input)
    if args.engine == "ref":
        from .ref.codec import decode_sela as ref_decode
        from .ref.codec import encode_wav as ref_encode

        buf = ref_encode(w, profile=_profile_from(args))
        out = ref_decode(buf)
    else:
        buf = encode_wav(w, chunk_frames=args.chunk_frames,
                         profile=_profile_from(args), device=_device(args))
        out = decode_sela(buf, chunk_frames=args.chunk_frames,
                          device=_device(args))
    ok = (
        out.sample_rate == w.sample_rate
        and out.bits_per_sample == w.bits_per_sample
        and len(out.channels) == len(w.channels)
        and all(np.array_equal(a, b) for a, b in zip(out.channels, w.channels))
    )
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(f"verify {args.input}: {'BIT-EXACT' if ok else 'MISMATCH'} "
          f"(ratio {len(buf) / raw:.3f}, {_engine(args)})")
    return 0 if ok else 1


def cmd_decode(args) -> int:
    from .ref.wav import write_wav
    from .utils.metrics import profiler_trace

    with open(args.input, "rb") as f:
        buf = f.read()
    m = _metrics_from(args)
    t0 = time.perf_counter()
    with profiler_trace(args.profile_trace):
        if args.engine == "ref":
            from .ref.codec import decode_sela

            w = decode_sela(buf)
        else:
            from .codec.decoder import decode_sela

            w = decode_sela(buf, chunk_frames=args.chunk_frames, metrics=m,
                            device=_device(args))
    dt = time.perf_counter() - t0
    write_wav(args.output, w)
    if args.log_json:
        m.emit("decode")
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(
        f"decoded {args.input}: {_human(len(buf))} -> {_human(raw)} "
        f"in {dt:.2f}s [{_human(raw / dt)}/s, {_engine(args)}]"
    )
    return 0


def cmd_info(args) -> int:
    from .ref import container

    with open(args.input, "rb") as f:
        buf = f.read()
    h = container.parse_header(buf)
    pos = container.HEADER_SIZE
    n_samples = 0
    orders = []
    ms_frames = 0
    for _ in range(h.num_frames):
        sfs, ns, pos = container.parse_frame(buf, pos, h.channels)
        n_samples += ns
        orders += [sf.order for sf in sfs]
        if any(sf.sftype == 1 for sf in sfs):
            ms_frames += 1
    tags = container.parse_trailer(buf, pos)
    dur = n_samples / h.sample_rate
    mean_order = float(np.mean(orders)) if orders else 0.0
    print(
        f"{args.input}: {h.sample_rate} Hz, {h.bits_per_sample}-bit, "
        f"{h.channels} ch, {h.num_frames} frames, {dur:.2f}s\n"
        f"  mean LPC order {mean_order:.1f}, mid/side frames "
        f"{ms_frames}/{h.num_frames}, {_human(len(buf))}"
    )
    for k, v in tags.items():
        print(f"  tag {k} = {v if isinstance(v, str) else f'<{len(v)} bytes>'}")
    return 0


def cmd_tag(args) -> int:
    """Read or edit the metadata trailer without re-encoding audio."""
    from .ref import container

    with open(args.input, "rb") as f:
        buf = f.read()
    if args.set or args.clear:
        tags = {} if args.clear else dict(container.read_tags(buf))
        tags.update(_parse_tags(args.set or []))
        out = container.replace_tags(buf, tags, fmt=args.format)
        with open(args.output or args.input, "wb") as f:
            f.write(out)
        print(f"wrote {len(tags)} tag(s) to {args.output or args.input}")
        return 0
    tags = container.read_tags(buf)
    if not tags:
        print(f"{args.input}: no tags")
    for k, v in tags.items():
        print(f"{k} = {v if isinstance(v, str) else f'<{len(v)} bytes>'}")
    return 0


def cmd_play(args) -> int:
    """Decode incrementally through the streaming player. The port has no
    audio output: the stream is consumed at full speed and, with --wav-out,
    written to a WAV file."""
    from .codec.stream import StreamingPlayer
    from .ref.wav import WavData, write_wav

    with open(args.input, "rb") as f:
        buf = f.read()
    player = StreamingPlayer(buf, chunk_frames=args.chunk_frames,
                             device=_device(args))
    h = player.header
    blocks = list(player)
    n = sum(len(b) for b in blocks)
    if args.wav_out:
        pcm = (np.concatenate(blocks) if blocks
               else np.zeros((0, h.channels), np.int32))
        write_wav(args.wav_out, WavData(
            h.sample_rate, h.bits_per_sample,
            [pcm[:, c].copy() for c in range(h.channels)]))
        print(f"no audio output; streamed {n / h.sample_rate:.2f}s of audio "
              f"to {args.wav_out}")
    else:
        print(f"no audio output; stream-decoded {n / h.sample_rate:.2f}s "
              f"({h.sample_rate} Hz, {h.channels} ch) - use --wav-out to save")
    return 0


def cmd_encode_batch(args) -> int:
    import os

    from .codec.corpus import encode_files
    from .ref.wav import read_wav

    wavs = [read_wav(p) for p in args.inputs]
    t0 = time.perf_counter()
    bufs = encode_files(wavs, chunk_frames=args.chunk_frames,
                        device=_device(args))
    dt = time.perf_counter() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    raw = comp = 0
    for p, w, buf in zip(args.inputs, wavs, bufs):
        name = os.path.splitext(os.path.basename(p))[0] + ".sela"
        with open(os.path.join(args.out_dir, name), "wb") as f:
            f.write(buf)
        raw += w.n_samples * w.n_channels * w.bits_per_sample // 8
        comp += len(buf)
    print(f"encoded {len(wavs)} files: {_human(raw)} -> {_human(comp)} "
          f"(ratio {comp / raw:.3f}) in {dt:.2f}s [{_human(raw / dt)}/s]")
    return 0


def cmd_decode_batch(args) -> int:
    import os

    from .codec.corpus import decode_files
    from .ref.wav import write_wav

    bufs = []
    for p in args.inputs:
        with open(p, "rb") as f:
            bufs.append(f.read())
    t0 = time.perf_counter()
    wavs = decode_files(bufs, chunk_frames=args.chunk_frames,
                        device=_device(args))
    dt = time.perf_counter() - t0
    os.makedirs(args.out_dir, exist_ok=True)
    raw = 0
    for p, w in zip(args.inputs, wavs):
        name = os.path.splitext(os.path.basename(p))[0] + ".wav"
        write_wav(os.path.join(args.out_dir, name), w)
        raw += w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(f"decoded {len(wavs)} files: {_human(raw)} in {dt:.2f}s "
          f"[{_human(raw / dt)}/s]")
    return 0


def cmd_encode_shard(args) -> int:
    import torch.distributed as dist

    from .parallel.multihost import encode_shard, init_distributed
    from .ref.wav import read_wav

    rank, n_hosts = args.rank, args.n_hosts
    if rank is None:   # the torch.distributed environment's topology
        rank, n_hosts = init_distributed()
    try:
        m = encode_shard(read_wav(args.input), args.out_dir, rank, n_hosts,
                         chunk_frames=args.chunk_frames, device=_device(args))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"shard {rank}/{n_hosts}: frames [{m['frame_lo']}, {m['frame_hi']}) "
          f"-> {_human(m['bytes'])} ({m['sha256'][:12]}) in {m['wall_s']:.2f}s")
    return 0


def cmd_merge_shards(args) -> int:
    from .parallel.multihost import merge_shards, missing_shards

    missing = missing_shards(args.shard_dir, args.n_hosts)
    if missing:
        print(f"error: missing shards {missing}: re-run encode-shard for them",
              file=sys.stderr)
        return 3
    info = merge_shards(args.shard_dir, args.n_hosts, args.output)
    print(f"merged {info['hosts']} shards, {info['frames']} frames -> "
          f"{args.output}")
    return 0


def cmd_bench(args) -> int:
    from .bench import run_bench

    run_bench(args.seconds, _device(args), args.detail)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .codec.decoder import DEFAULT_CHUNK_FRAMES
    from .codec.stream import DEFAULT_CHUNK_FRAMES as STREAM_CHUNK_FRAMES

    ap = argparse.ArgumentParser(prog="python -m sela_tpu_torch.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help, chunk_frames=DEFAULT_CHUNK_FRAMES):
        sp = sub.add_parser(name, help=help)
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain PyTorch versions of the "
                             "kernels)")
        sp.add_argument("--chunk-frames", type=int, default=chunk_frames)
        sp.set_defaults(fn=fn)
        return sp

    def add_profile_flags(sp):
        sp.add_argument("--frame-size", type=int, default=None,
                        help="samples a channel a frame (<= 2048)")
        sp.add_argument("--max-order", type=int, default=None,
                        help="LPC order search cap (<= 32)")
        sp.add_argument("--rice-k-max", type=int, default=None,
                        help="Rice optimal-k search cap (<= 30)")
        ms = sp.add_mutually_exclusive_group()
        ms.add_argument("--no-mid-side", action="store_true",
                        help="direct L/R subframes only")
        ms.add_argument("--exact-mid-side", action="store_true",
                        help="decide mid/side from exact coded bits (renders "
                             "every candidate)")
        sp.add_argument("--partition-residues", action="store_true",
                        help="adaptive 4-way partitioned residues (smaller "
                             "files on transient content; FORMAT.md)")

    def add_engine(sp, observe=True):
        sp.add_argument("--engine", choices=("torch", "ref"), default="torch",
                        help="torch = the device codec (default), ref = the "
                             "numpy oracle")
        if observe:
            sp.add_argument("--log-json", action="store_true",
                            help="emit one JSON-lines metrics record to "
                                 "stderr")
            sp.add_argument("--profile-trace", default=None, metavar="DIR",
                            help="write a torch.profiler trace (Chrome/"
                                 "Perfetto JSON) into DIR")

    enc = add("encode", cmd_encode, "WAV -> .sela")
    enc.add_argument("input")
    enc.add_argument("output")
    enc.add_argument("--tag", action="append", metavar="KEY=VALUE",
                     dest="tags", help="attach a metadata tag (repeatable)")
    add_profile_flags(enc)
    add_engine(enc)
    dec = add("decode", cmd_decode, ".sela -> WAV")
    dec.add_argument("input")
    dec.add_argument("output")
    add_engine(dec)
    ver = add("verify", cmd_verify, "encode + decode, check bit-exactness")
    ver.add_argument("input")
    add_profile_flags(ver)
    add_engine(ver, observe=False)
    inf = sub.add_parser("info", help="container info")
    inf.add_argument("input")
    inf.set_defaults(fn=cmd_info)
    tag = sub.add_parser("tag", help="read/edit metadata tags (no re-encode)")
    tag.add_argument("input")
    tag.add_argument("--set", action="append", metavar="KEY=VALUE",
                     help="set a tag (repeatable)")
    tag.add_argument("--clear", action="store_true",
                     help="drop existing tags before applying --set")
    tag.add_argument("--format", choices=("setg", "apev2"), default="setg",
                     help="wire format for the written trailer: the compact "
                          "SeTg block or a real APEv2 header+items+footer "
                          "(reads auto-detect either)")
    tag.add_argument("--output", default=None,
                     help="write result here instead of in place")
    tag.set_defaults(fn=cmd_tag)
    ply = add("play", cmd_play, "stream-decode (to a WAV with --wav-out)",
              chunk_frames=STREAM_CHUNK_FRAMES)
    ply.add_argument("input")
    ply.add_argument("--wav-out", default=None)
    ben = add("bench", cmd_bench, "throughput benchmark (one JSON line)")
    ben.add_argument("--seconds", type=float, default=60.0)
    ben.add_argument("--detail", default=None, metavar="PATH",
                     help="write the full detail here as JSON")
    eb = add("encode-batch", cmd_encode_batch, "batch WAVs -> .sela dir")
    eb.add_argument("inputs", nargs="+")
    eb.add_argument("out_dir")
    db = add("decode-batch", cmd_decode_batch, "batch .sela -> WAV dir")
    db.add_argument("inputs", nargs="+")
    db.add_argument("out_dir")
    es = add("encode-shard", cmd_encode_shard,
             "encode one rank's frame range of a long WAV")
    es.add_argument("input")
    es.add_argument("out_dir")
    es.add_argument("--rank", type=int, default=None)
    es.add_argument("--n-hosts", type=int, default=1)
    ms = add("merge-shards", cmd_merge_shards,
             "rank-ordered merge of shard parts into one .sela")
    ms.add_argument("shard_dir")
    ms.add_argument("output")
    ms.add_argument("--n-hosts", type=int, required=True)
    return ap


ALIASES = {"-e": "encode", "-d": "decode", "-p": "play"}


def main(argv: list[str] | None = None) -> int:
    from .errors import ContainerError
    from .ref.wav import WavError

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ALIASES:
        argv[0] = ALIASES[argv[0]]
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
    except (ContainerError, WavError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
