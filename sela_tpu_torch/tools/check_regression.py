"""Benchmark regression gate for two lines of `python -m sela_tpu_torch.bench`.

    python -m sela_tpu_torch.tools.check_regression --previous A.json
                                                    --current B.json
                                                    [--ratio-tol 0.02]
                                                    [--tput-tol 0.10]

Counterpart of tools/check_regression.py. Each file holds one bench line
(or a record with it under "parsed"). Exits 1 when a gated metric
regresses:
  * a compression ratio grows by more than RATIO_TOL (2%): the CD track,
    its v2 encode, the 24-bit and 32-bit clips, batch64;
  * a device-side rate drops by more than TPUT_TOL (10%): the device
    pipeline's encode and decode GB/s, the host packer's pack and unpack
    MB/s, and the device packer's kernel (its kernel_ms, as a rate).
The walls (end-to-end seconds and GB/s, the packer's fetch and host
walls) and the link's copy rates are compared and printed but never
fatal: the CD walls spread 0.158-0.428 s between runs of one tree on one
card (PERF.md section 5), wider than any tolerance. Only metrics present
in both lines are compared.

Prints one JSON line on stdout (the device, the shared metrics' count,
the failures and the informational notes), details on stderr.

Two lines whose `device.name` differ, or that lack one, are refused with
exit 2: numbers from two chips are not comparable, and a TPU record
(`BENCH_r*.json`) is never a card's baseline. There is no automatic mode
over the repo's records (the JAX tool's default); both files are named.
"""
from __future__ import annotations

import argparse
import json
import sys

RATIO_TOL = 0.02   # compressed size may grow at most 2% relative
TPUT_TOL = 0.10    # a rate may drop at most 10% relative

CONFIGS = ("e2e_cd", "e2e_cd_v2", "e2e_hires", "e2e_32bit", "batch64")
WALLS = ("encode_s", "decode_s", "per_file_encode_s", "per_file_decode_s")


def normalize(rec: dict) -> dict:
    """Flatten a bench line into {name: (value, kind, gated)}; kind is
    "ratio" (lower is better, RATIO_TOL), "rate" (higher is better,
    TPUT_TOL) or "time" (lower is better, held as the rate 1/t)."""
    out: dict[str, tuple[float, str, bool]] = {}
    s = rec.get("summary", {})

    def put(name, val, kind, gated):
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            out[name] = (float(val), kind, gated)

    put("e2e_cd.aggregate_gbps", rec.get("value"), "rate", False)
    for cfg in CONFIGS:
        sub = s.get(cfg, {})
        put(f"{cfg}.compression_ratio", sub.get("compression_ratio"), "ratio",
            True)
        for wall in WALLS:
            put(f"{cfg}.{wall}", sub.get(wall), "time", False)
    dp = s.get("device_pipeline_gbps", {})
    put("device_pipeline.encode_gbps", dp.get("encode_gbps"), "rate", True)
    put("device_pipeline.decode_gbps", dp.get("decode_gbps"), "rate", True)
    put("host_pack_mb_per_s", s.get("host_pack_mb_per_s"), "rate", True)
    put("host_unpack_mb_per_s", s.get("host_unpack_mb_per_s"), "rate", True)
    pack = s.get("device_pack", {})
    put("device_pack.kernel_ms", pack.get("kernel_ms"), "time", True)
    put("device_pack.kernel_and_fetch_s", pack.get("kernel_and_fetch_s"),
        "time", False)
    put("device_pack.host_pack_s", pack.get("host_pack_s"), "time", False)
    for k, v in (s.get("link_mb_per_s") or {}).items():
        put(f"link.{k}_mb_per_s", v, "rate", False)
    return out


def device_name(rec) -> str | None:
    dev = rec.get("device") if isinstance(rec, dict) else None
    return dev.get("name") if isinstance(dev, dict) else None


def compare(prev: dict, cur: dict, ratio_tol: float = RATIO_TOL,
            tput_tol: float = TPUT_TOL, notes: list | None = None) -> list[str]:
    """Gate failures (empty = pass); informational deltas out of tolerance
    go to `notes` when given. Raises ValueError for two lines of different
    (or unnamed) devices."""
    if device_name(prev) is None or device_name(prev) != device_name(cur):
        raise ValueError(f"the lines come from different devices "
                         f"({device_name(prev)!r} and {device_name(cur)!r}): "
                         "not comparable")
    p, c = normalize(prev), normalize(cur)
    failures = []
    for name in sorted(set(p) & set(c)):
        pv, kind, gated = p[name]
        cv = c[name][0]
        if pv <= 0 or cv <= 0:
            continue
        if kind == "ratio":
            change, tol, word = (cv - pv) / pv, ratio_tol, "+"
        else:   # a rate, or a time held as the rate 1/t
            rate_p, rate_c = (pv, cv) if kind == "rate" else (1 / pv, 1 / cv)
            change, tol, word = (rate_p - rate_c) / rate_p, tput_tol, "-"
        if change > tol:
            what = "rate " if kind == "time" else ""
            msg = (f"{name}: {pv:.6g} -> {cv:.6g} ({what}{word}"
                   f"{change * 100:.1f}% > {tol * 100:.0f}% allowed)")
            if gated:
                failures.append(msg)
            elif notes is not None:
                notes.append(msg)
    return failures


def _load(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    parsed = rec.get("parsed") if isinstance(rec, dict) else None
    return parsed if isinstance(parsed, dict) else rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sela_tpu_torch.tools.check_regression",
        description=__doc__.splitlines()[0])
    ap.add_argument("--previous", required=True, help="baseline bench line")
    ap.add_argument("--current", required=True, help="bench line to gate")
    ap.add_argument("--ratio-tol", type=float, default=RATIO_TOL)
    ap.add_argument("--tput-tol", type=float, default=TPUT_TOL)
    args = ap.parse_args(argv)
    prev, cur = _load(args.previous), _load(args.current)
    notes: list[str] = []
    try:
        failures = compare(prev, cur, args.ratio_tol, args.tput_tol, notes)
    except ValueError as e:
        print(f"refused: {e}", file=sys.stderr)
        print(json.dumps({"verdict": "refused", "reason": str(e)}), flush=True)
        return 2
    shared = sorted(set(normalize(prev)) & set(normalize(cur)))
    print(f"compared {args.previous} -> {args.current} on "
          f"{device_name(cur)}: {len(shared)} shared metrics", file=sys.stderr)
    for n in notes:
        print(f"  INFO (not gated): {n}", file=sys.stderr)
    for f in failures:
        print(f"REGRESSION: {f}", file=sys.stderr)
    print(json.dumps({"verdict": "regression" if failures else "pass",
                      "device": device_name(cur), "shared_metrics": len(shared),
                      "failures": failures, "notes": notes}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
