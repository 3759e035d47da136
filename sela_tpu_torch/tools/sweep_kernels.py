"""Time the encode kernels and the encode step at one chunk size.

    python -m sela_tpu_torch.tools.sweep_kernels [F] [--cpu] [--out PATH]

Counterpart of tools/sweep_kernels.py: K5 (fir_rice) and K3 (autocorr) on
the JAX tool's 4F rows of 2,048 samples of the bench corpus, and
`encode_step` on its F frames (default 4,096), one F a run. Prints one
line a measurement to stderr and one JSON line on stdout (ms and
PCM16-equivalent GB/s of the F frames), written to PATH only with --out.
Times are CUDA events around 10 back-to-back calls behind a device-side
sleep, the minimum of 5; --cpu runs the plain versions on the CPU.

JAX knobs without a counterpart: the tile sizes SELA_FIR_ROWS and
SELA_AC_ROWS that the JAX tool sweeps. The CUDA kernels' geometry is fixed
(K5 a block of 4 warps a row, K3 a warp a row), so no variable selects one.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..utils.device import resolve_device
from ._common import (candidate_rows, corpus_frames, device_ms, device_record,
                      emit)


def sweep(F: int = 4096, device=None, corpus_s: float = 120.0) -> dict:
    """K5, K3 and encode_step at F frames on `device` (default: the card)."""
    from ..codec.pipeline import encode_step
    from ..ops.analysis import analyze, autocorr
    from ..ops.coeffs import lpc_from_q
    from ..ops.filters import fir_rice

    dev = resolve_device(device)
    x, n_valid = corpus_frames(F, corpus_s)
    xd, nvd = torch.from_numpy(x).to(dev), torch.from_numpy(n_valid).to(dev)
    xb, nv = (torch.from_numpy(a).to(dev) for a in candidate_rows(x, n_valid))
    order, q, _ = analyze(xb, nv)
    c = lpc_from_q(q, order)
    pcm = F * 2 * x.shape[-1] * 2
    rec = {"device": device_record(dev), "F": F}
    for name, fn in (("fir_rice", lambda: fir_rice(xb, c, order, nv)),
                     ("autocorr", lambda: autocorr(xb)),
                     ("encode_step", lambda: encode_step(xd, nvd))):
        ms = device_ms(fn, dev)
        rec[name] = {"ms": ms, "pcm16_gbps": pcm / ms / 1e6}
        print(f"[F={F}] {name:12s} {ms:9.4f} ms  {pcm / ms / 1e6:6.2f} GB/s-eq",
              file=sys.stderr)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sela_tpu_torch.tools.sweep_kernels",
        description=__doc__.splitlines()[0])
    ap.add_argument("F", nargs="?", type=int, default=4096,
                    help="frames (4F rows for the kernels)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON line here")
    args = ap.parse_args(argv)
    emit(sweep(args.F, "cpu" if args.cpu else None), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
