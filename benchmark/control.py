"""The benchmark's control: a cell run with its program swapped for a
version that breaks the configuration's guarantee, which the checks must
refuse (`correct` false on every seed).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

prints one JSON line a seed (its checks and `correct`) and exits 1 if any
control run came out correct. The control is the cell's op's own
(`ops/<op>.py::control`), put in the program's place underneath the harness
for the length of the runs; the encode op's is the program's encode_wav of
the PCM with its lowest bit cleared: one bit less than the configuration's
depth (a lossy encoder).

The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextmanager
def controlled(workload: str, root: str = ROOT):
    """The program's entry points that `workload`'s op drives, replaced by
    the op's control until the block ends."""
    from benchmark import harness
    from benchmark.traffic import load_named

    _, _, mix = harness.load_cell(harness.load_spec(root), workload, root)
    op = load_named("ops", mix["op"], os.path.join(root, "benchmark"))
    patches = op.control()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    try:
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with controlled(args.workload):
            out = harness.run_cell(args.workload, seed, args.seconds, False,
                                   t0)
        wrong += out["correct"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
