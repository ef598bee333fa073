"""Readings that the limits of ``correct`` are set from: the compared
numbers of the program, of the control (the reference with every
product's operands in float8 e4m3 in the program's place) and of a
planted fault, over several seeds, at the cell's own size, one JSON line
a seed.  PERF.md lists the readings and the limits set from them.

    python3 portbench/calibrate.py --workload flagship-train \
        --seeds 1,2,3 --what control
    python3 portbench/calibrate.py --workload flagship-serve \
        --seeds 1,2,3 --what program --seconds 3
    python3 portbench/calibrate.py --workload flagship-train \
        --seeds 1,2,3 --what fault:half_batch --seconds 1

``--served`` is how many requests a serving run's window finishes, so
that the control compares as many requests as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import env  # noqa: E402

env.prepare()

from harness import bench, runner  # noqa: E402


def readings(cell, seed: int, what: str, seconds: float, served: int,
             device: str = "cuda") -> dict:
    if what == "control":
        ctx = runner.Context(cell, seed, seconds, False, device)
        driver = cell.driver()
        if cell.traffic["driver"] == "serve":
            return driver.control(ctx, served)
        return driver.control(ctx)
    fault = what.split(":", 1)[1] if what.startswith("fault:") else None
    ctx = runner.Context(cell, seed, seconds, False, device, fault)
    return cell.driver().run(ctx).numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--what", default="program")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--served", type=int, default=600)
    args = parser.parse_args(argv)
    cell = bench.load_cell(args.workload)
    runner.require_devices(cell.chips)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(cell, seed, args.what, args.seconds, args.served)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
