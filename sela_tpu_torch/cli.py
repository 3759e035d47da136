"""Command-line interface of the PyTorch/CUDA port.

    python -m sela_tpu_torch.cli decode in.sela out.wav [--cpu] [--chunk-frames N]
    python -m sela_tpu_torch.cli info file.sela

`decode` runs on the CUDA card unless --cpu is given (then the plain
PyTorch versions of the kernels run). The `selax` entry point of the JAX
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


def cmd_decode(args) -> int:
    from .codec.decoder import decode_sela
    from .ref.wav import write_wav

    with open(args.input, "rb") as f:
        buf = f.read()
    t0 = time.perf_counter()
    w = decode_sela(buf, chunk_frames=args.chunk_frames,
                    device="cpu" if args.cpu else None)
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
    dec = sub.add_parser("decode", help=".sela -> WAV")
    dec.add_argument("input")
    dec.add_argument("output")
    dec.add_argument("--cpu", action="store_true",
                     help="run on the CPU (plain PyTorch versions of the kernels)")
    dec.add_argument("--chunk-frames", type=int, default=DEFAULT_CHUNK_FRAMES)
    dec.set_defaults(fn=cmd_decode)
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
