#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port, one cell per process.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds the port beside this folder.
The cell is `workloads/CELL.json`; it names its configuration
(`configs/<config>.json`) and its driver (`drivers/<driver>.py`).  With
`--trace 0` the last line of standard output is the JSON result with the
cell's end-to-end metrics; with `--trace 1` it holds the per-layer metrics
that the readers in `metrics/` find in a traced window.  Exits non-zero,
printing no result, without a CUDA device.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import runner  # noqa: E402

if __name__ == '__main__':
  sys.exit(runner.main(sys.argv[1:], START))
