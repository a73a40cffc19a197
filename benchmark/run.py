"""One run of one cell of the port's benchmark:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the result as the last line of its
standard output, and each compared number beside its limit as the last
lines of its standard error.  Needs a CUDA device; without one it exits
with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root in place of this script's folder: the harness is
# the package ``benchmark``, and the system under test is imported from
# the checkout, which also holds its kernels' build directory
sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
