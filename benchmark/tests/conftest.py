"""The benchmark's own tests: python -m pytest benchmark/tests from the
root of the checkout. They run the cells on the CPU at sizes a test run
can hold; the test marked `cuda` runs one on the card where there is one."""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a cell at a size a test run can hold: 3 s tracks (65 CD frames), a
# two-request traced stretch, every output kept
SMALL = {"config": {"track_seconds": 3.0},
         "mix": {"trace_requests": 2, "keep_share": 1.0}}
CELLS = ("cd16_v1.ingest", "hires24_v2.ingest")
