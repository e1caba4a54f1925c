"""Runs one cell of the port's benchmark once and prints its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The last
line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, then ``check``: each number compared beside its limit); the
same numbers are the last lines of standard error. Without a card it exits
3 and prints no result. ``--variant control`` puts the cell's correctness
control in the program's place (the check's readings; never in a
benchmark run).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", choices=("program", "control"), default="program")
    return p.parse_args(argv)


if __name__ == "__main__":
    from port_bench import harness

    sys.exit(harness.main(parse(), T_START))
