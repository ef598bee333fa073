"""The benchmark of ``scat_tpu_torch`` on one H100: one run of one cell.

    python3 portbench/run.py --workload flagship-train --seed 7 \
        --seconds 20 --trace 0

The cell, its configuration, traffic mix, driver and per-layer metrics
are found by the names in ``BENCHMARK.json`` (``harness/bench.py``).
With ``--trace 0`` the result line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy and window
seconds and a ``breakdown``.  Without CUDA, or with fewer devices than
the cell asks for, it prints no result and exits with 1.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import env  # noqa: E402

env.prepare()

from harness import bench, runner  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = bench.load_cell(args.workload)
        runner.require_devices(cell.chips)
        line = runner.run_cell(cell, args.seed, args.seconds,
                               bool(args.trace))
    except Exception:   # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    runner.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
