#!/usr/bin/env python3
"""The benchmark of dagr_tpu_torch: run one cell of BENCHMARK.json once.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``dagr_tpu_torch``) on a machine with the CUDA devices the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` the ``breakdown``, and last the ``checks``: each number compared
with the plain reference beside its limit.  Without the devices, or
with a forbidden module loaded, it exits non-zero and prints no result.
"""
import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
