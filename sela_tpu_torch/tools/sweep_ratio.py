"""Ratio-knob sweep against the bench corpus.

    python -m sela_tpu_torch.tools.sweep_ratio [--seconds 10] [--seed 0]
                                               [--cpu] [--out PATH]

Counterpart of tools/sweep_ratio.py, with its four sections:
  1. the COEFF_BIT_COST sweep (the order-selection header-cost model, 4..10,
     with the quantization-noise penalty; and the model without it): total
     exact stream bits of the corpus per setting;
  2. the exact-order headroom: every (frame, candidate) row rendered at all
     33 orders (on the card K1 -> K5 -> the render's Rice planning, K6, 33
     times over all candidate rows), the true-minimum exact bits against the
     modeled choice;
  3. the wasted-bits headroom: shared trailing zero bits and constant rows
     of the raw channels;
  4. the partitioned-residue (v2) statistics: its container ratio against
     v1's, the v2 stream decoded back first.
The full-order analysis is the plain float Levinson
(ops/analysis.py::levinson_full_reference) on K3's autocorrelation, as the
JAX tool uses its jnp Levinson and not the kernel: K4 does not output the
errors of every order.

Prints one JSON line on stdout (progress to stderr), written to PATH only
with --out. Runs on the card unless --cpu (plain versions on the CPU). The
JAX tool's JAX_PLATFORMS default (the CPU) has no counterpart: the card is
the default here.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..utils.device import resolve_device
from ._common import device_record, emit

COEFF_BIT_COSTS = (4, 5, 6, 7, 8, 9, 10)


def _log(msg: str) -> None:
    print(f"[sweep] {msg}", file=sys.stderr, flush=True)


def exact_bits_for_orders(xb: torch.Tensor, q_full: torch.Tensor,
                          nv: torch.Tensor, rice_k_max: int = 30) -> np.ndarray:
    """[B, S] rows + [B, 32] full-order quantized reflections + [B] counts
    (int32, one device) -> [B, 33] exact padded-word stream bits of every
    candidate order: the render's K1 -> K5 -> K6 (rice_plan) at each."""
    from ..ops.coeffs import lpc_from_q
    from ..ops.filters import fir_rice
    from ..ops.rice import rice_plan

    B, P = q_full.shape
    cols = torch.arange(P, device=q_full.device)[None, :]
    out = []
    for m in range(P + 1):
        q_m = torch.where(cols < m, q_full, 0).contiguous()
        order = torch.full((B,), m, dtype=torch.int32, device=q_full.device)
        c = lpc_from_q(q_m, order)
        _, eff, counts = fir_rice(xb, c, order, nv)
        plan = rice_plan(counts, q_m, eff, nv, rice_k_max)
        out.append((32 * (plan["nw_res"] + plan["nw_coeff"])).cpu().numpy())
    return np.stack(out, axis=1)


def corpus_bits(bits_all: np.ndarray, order_choice: np.ndarray, F: int,
                C2: int) -> int:
    """Frame-level stream bits for a per-row order choice, each pair's
    mid/side picked by exact bits (the oracle rule)."""
    b = np.take_along_axis(bits_all, order_choice[:, None], axis=1)[:, 0]
    b = b.reshape(F, C2)
    return int(np.minimum(b[:, 0] + b[:, 1], b[:, 2] + b[:, 3]).sum())


def coeff_bit_cost_sweep(err: np.ndarray, nv: np.ndarray, bits_all: np.ndarray,
                         F: int, C2: int, penalty: float) -> tuple[dict, int]:
    """Section 1: the corpus's stream bits under the modeled order choice for
    each COEFF_BIT_COST (with the quantization-noise penalty), and under the
    model without the penalty at COEFF_BIT_COST 7."""
    err = err.astype(np.float64)
    nvf = nv.astype(np.float64)[:, None]
    m = np.arange(err.shape[1], dtype=np.float64)[None, :]
    adj = err + penalty * m * err[:, :1]
    logerr = 0.5 * nvf * np.log2(np.maximum(adj, 1e-9))
    sweep = {str(cbc): corpus_bits(bits_all, np.argmin(logerr + cbc * m, axis=1)
                                   .astype(np.int64), F, C2)
             for cbc in COEFF_BIT_COSTS}
    plain = 0.5 * nvf * np.log2(np.maximum(err, 1e-9)) + 7 * m
    return sweep, corpus_bits(bits_all, np.argmin(plain, axis=1)
                              .astype(np.int64), F, C2)


def wasted_bits(x: np.ndarray, n_valid: np.ndarray) -> tuple[int, int]:
    """Section 3 on raw channel rows: (shared trailing zero bits x samples,
    constant or silent rows)."""
    F, C, S = x.shape
    xr = x.reshape(F * C, S)
    nvr = np.repeat(n_valid, C)
    total = const = 0
    for i in range(xr.shape[0]):
        v = xr[i, : nvr[i]]
        nz = v[v != 0]
        if nz.size == 0 or (v == v[0]).all():
            const += 1
            continue
        nzv = nz.astype(np.int64)
        total += int(np.log2((nzv & -nzv).astype(np.float64)).min()) * int(nvr[i])
    return total, const


def sweep(seconds: float = 10.0, seed: int = 0, device=None) -> dict:
    """The four sections on `seconds` of the bench corpus (seed `seed`)."""
    from ..bench import make_corpus
    from ..codec.decoder import decode_sela
    from ..codec.encoder import encode_wav, frame_batches
    from ..codec.pipeline import make_candidates
    from ..config import BitstreamProfile
    from ..format import ORDER_QNOISE_PENALTY
    from ..ops.analysis import autocorr, levinson_full_reference
    from ..ref.wav import WavData

    dev = resolve_device(device)
    left, right = make_corpus(seconds, seed=seed)
    w = WavData(44100, 16, [left, right])
    pcm_bytes = w.n_samples * w.n_channels * 2
    rec: dict = {"device": device_record(dev), "seconds": seconds,
                 "seed": seed, "pcm_bytes": pcm_bytes}
    buf = encode_wav(w, device=dev)
    rec["baseline_ratio_v1"] = len(buf) / pcm_bytes
    _log(f"baseline v1 container ratio {rec['baseline_ratio_v1']:.6f}")

    x, n_valid = frame_batches([left, right])
    cand = make_candidates(torch.from_numpy(np.ascontiguousarray(x)).to(dev))
    F, C2, S = cand.shape
    xb = cand.reshape(F * C2, S).contiguous()
    nv_np = np.repeat(n_valid, C2).astype(np.int32)
    nv = torch.from_numpy(nv_np).to(dev)
    err, q_full = levinson_full_reference(autocorr(xb))
    bits_all = exact_bits_for_orders(xb, q_full, nv)

    sweep_bits, no_penalty = coeff_bit_cost_sweep(
        err.cpu().numpy(), nv_np, bits_all, F, C2, ORDER_QNOISE_PENALTY)
    base7 = sweep_bits["7"]
    rec["coeff_bit_cost_sweep_stream_bits"] = sweep_bits
    rec["coeff_bit_cost_rel_to_7"] = {
        k: (v - base7) / base7 * 100 for k, v in sweep_bits.items()}
    rec["no_penalty_model_stream_bits"] = no_penalty
    rec["penalty_gain_pct"] = (no_penalty - base7) / no_penalty * 100
    _log(f"COEFF_BIT_COST rel%: {rec['coeff_bit_cost_rel_to_7']}; penalty "
         f"gain {rec['penalty_gain_pct']:.4f}%")

    exact_best = corpus_bits(bits_all, np.argmin(bits_all, axis=1)
                             .astype(np.int64), F, C2)
    rec["exact_order_stream_bits"] = exact_best
    rec["exact_order_gain_vs_model7_pct"] = (base7 - exact_best) / base7 * 100
    _log(f"exact-order search would gain "
         f"{rec['exact_order_gain_vs_model7_pct']:.4f}% over model(7)")

    total, const = wasted_bits(x, n_valid)
    rec["wasted_bits_headroom_pct_of_stream"] = total / max(base7, 1) * 100
    rec["constant_or_silent_rows"] = const
    _log(f"wasted-bits headroom {rec['wasted_bits_headroom_pct_of_stream']}% "
         f"of stream; constant rows {const}/{F * x.shape[1]}")

    buf2 = encode_wav(w, profile=BitstreamProfile(residue_partition=4),
                      device=dev)
    back = decode_sela(buf2, device=dev)
    if not all(np.array_equal(a, b) for a, b in zip(back.channels, w.channels)):
        raise RuntimeError("the v2 stream does not decode to the input")
    rec["partitioned_v2_ratio"] = len(buf2) / pcm_bytes
    rec["partitioned_v2_delta_pct"] = (len(buf2) - len(buf)) / len(buf) * 100
    _log(f"v2 ratio {rec['partitioned_v2_ratio']:.6f} "
         f"({rec['partitioned_v2_delta_pct']:+.4f}% vs v1)")
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sela_tpu_torch.tools.sweep_ratio",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON line here")
    args = ap.parse_args(argv)
    emit(sweep(args.seconds, args.seed,
                            "cpu" if args.cpu else None), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
