"""Command-line interface of the PyTorch/CUDA port.

    python -m sela_tpu_torch.cli encode in.wav out.sela [--cpu] [profile flags]
                                        [--tag KEY=VALUE ...]
    python -m sela_tpu_torch.cli decode in.sela out.wav [--cpu] [--chunk-frames N]
    python -m sela_tpu_torch.cli verify in.wav [--cpu] [profile flags]
    python -m sela_tpu_torch.cli info file.sela

`encode`, `decode` and `verify` run on the CUDA card unless --cpu is given
(then the plain PyTorch versions of the kernels run). Profile flags:
--frame-size, --max-order, --rice-k-max, --no-mid-side, --exact-mid-side,
--partition-residues (the v2 profile). `encode --tag KEY=VALUE`
(repeatable) appends a tags trailer. The `selax` entry point of the JAX
package is separate and unchanged.
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


def cmd_encode(args) -> int:
    from .codec.encoder import encode_wav
    from .ref.wav import read_wav

    w = read_wav(args.input)
    profile = _profile_from(args)
    t0 = time.perf_counter()
    buf = encode_wav(w, chunk_frames=args.chunk_frames, profile=profile,
                     tags=_parse_tags(args.tags or []), device=_device(args))
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(buf)
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(
        f"encoded {args.input}: {_human(raw)} -> {_human(len(buf))} "
        f"(ratio {len(buf) / raw:.3f}) in {dt:.2f}s [{_human(raw / dt)}/s, "
        f"device={'cpu' if args.cpu else 'cuda'}]"
    )
    return 0


def cmd_verify(args) -> int:
    """Encode, decode, and check that the PCM comes back bit for bit."""
    from .codec.decoder import decode_sela
    from .codec.encoder import encode_wav
    from .ref.wav import read_wav

    w = read_wav(args.input)
    buf = encode_wav(w, chunk_frames=args.chunk_frames,
                     profile=_profile_from(args), device=_device(args))
    out = decode_sela(buf, chunk_frames=args.chunk_frames, device=_device(args))
    ok = (
        out.sample_rate == w.sample_rate
        and out.bits_per_sample == w.bits_per_sample
        and len(out.channels) == len(w.channels)
        and all(np.array_equal(a, b) for a, b in zip(out.channels, w.channels))
    )
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(f"verify {args.input}: {'BIT-EXACT' if ok else 'MISMATCH'} "
          f"(ratio {len(buf) / raw:.3f}, device="
          f"{'cpu' if args.cpu else 'cuda'})")
    return 0 if ok else 1


def cmd_decode(args) -> int:
    from .codec.decoder import decode_sela
    from .ref.wav import write_wav

    with open(args.input, "rb") as f:
        buf = f.read()
    t0 = time.perf_counter()
    w = decode_sela(buf, chunk_frames=args.chunk_frames, device=_device(args))
    dt = time.perf_counter() - t0
    write_wav(args.output, w)
    raw = w.n_samples * w.n_channels * w.bits_per_sample // 8
    print(
        f"decoded {args.input}: {_human(len(buf))} -> {_human(raw)} "
        f"in {dt:.2f}s [{_human(raw / dt)}/s, device="
        f"{'cpu' if args.cpu else 'cuda'}]"
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


def build_parser() -> argparse.ArgumentParser:
    from .codec.decoder import DEFAULT_CHUNK_FRAMES

    ap = argparse.ArgumentParser(prog="python -m sela_tpu_torch.cli",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, help):
        sp = sub.add_parser(name, help=help)
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain PyTorch versions of the "
                             "kernels)")
        sp.add_argument("--chunk-frames", type=int, default=DEFAULT_CHUNK_FRAMES)
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

    enc = add("encode", cmd_encode, "WAV -> .sela")
    enc.add_argument("input")
    enc.add_argument("output")
    enc.add_argument("--tag", action="append", metavar="KEY=VALUE",
                     dest="tags", help="attach a metadata tag (repeatable)")
    add_profile_flags(enc)
    dec = add("decode", cmd_decode, ".sela -> WAV")
    dec.add_argument("input")
    dec.add_argument("output")
    ver = add("verify", cmd_verify, "encode + decode, check bit-exactness")
    ver.add_argument("input")
    add_profile_flags(ver)
    inf = sub.add_parser("info", help="container info")
    inf.add_argument("input")
    inf.set_defaults(fn=cmd_info)
    return ap


def main(argv: list[str] | None = None) -> int:
    from .errors import ContainerError

    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ContainerError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
