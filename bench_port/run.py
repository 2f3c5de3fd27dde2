"""Run one cell of ``BENCHMARK.json`` once and print its result line.

From the root of a checkout::

    python3 bench_port/run.py --workload basic-sweep --seed 7 --seconds 10 --trace 0

It loads the program (``differt2d_tpu_torch``) from the checkout, builds
its kernels into ``build/differt2d_tpu_torch/`` there on the first run,
warms up the cell's shapes, measures for ``--seconds`` and checks the
window's maps against the plain reference in ``bench_port/reference/``.
The process keeps to one core and one PyTorch thread.  The last line of
standard output is the result as one JSON object; the
compared numbers and their limits are the last lines of standard error.
Without a CUDA device it exits with a code other than 0 and prints no
result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402


def one_core() -> None:
    """Keep the process, and every thread it starts from here on, on the
    core it runs on: the host's dispatch, which paces the basic cells,
    then reads alike from run to run."""
    try:
        with open("/proc/self/stat") as f:
            core = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        core = -1
    allowed = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {core if core in allowed else allowed[-1]})


one_core()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
