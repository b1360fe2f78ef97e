"""Readings for the limits of ``correct``: sound runs of the program, its
control and planted faults, on many seeds in one process. Not part of a
benchmark run.

    python3 benchmark/control.py --workload <cell> --modes sound,control \\
        --seeds 1,2,3 [--seconds 3] [--leaves]

Prints one JSON line a (mode, seed) with the numbers compared; needs the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from lhbench import readings, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", default="sound,control")
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--leaves", action="store_true",
                   help="a training cell's gaps leaf by leaf too")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs the card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load_benchmark(), a.workload)
    for mode in a.modes.split(","):
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            values = readings.reading(cell, seed, mode,
                                      torch.device("cuda", 0), a.seconds,
                                      a.leaves)
            print(json.dumps({"workload": a.workload, "mode": mode,
                              "seed": seed, **values,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
