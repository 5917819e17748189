"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA card(s) the
cell asks for. The last line of standard output is the result (JSON); the
last lines of standard error give each number the check compared, beside
its limit.
"""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, in place of this directory (whose modules would
# shadow the standard library's)
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_process=T_PROCESS))
