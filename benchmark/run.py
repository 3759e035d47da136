"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`, and
last `checks`: each number compared with its limit); the checks are also
the last lines of standard error. Exits 2, printing no result, without the
cards, when a module of JAX or of the JAX package is loaded, or when the
run cannot give a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        spec = harness.load_spec()
        wl, _, _ = harness.load_cell(spec, args.workload)
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < wl["chips"]):
            print(f"{args.workload} needs {wl['chips']} CUDA card(s); this "
                  "host has none or fewer", file=sys.stderr)
            return 2
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), T_START)
    except (harness.RunError, OSError, KeyError, ImportError) as e:
        print(f"no result: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
