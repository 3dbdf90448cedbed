"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result as one JSON object;
the compared numbers and their limits are the last lines of standard
error. See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_start=T_START))
