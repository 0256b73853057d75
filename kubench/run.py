"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 kubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``ku_torch``). Needs the
card(s) the cell asks for; see :mod:`kubench.harness.main`.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, not this directory, is where modules are found.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from kubench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
