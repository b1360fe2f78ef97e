"""The benchmark of ``lighthand_tpu_torch`` on NVIDIA GPUs: one run of one
cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program. The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; traced: ``breakdown``; and last, ``checks``: each
number compared with the reference, beside its limit), which also ends
standard error. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded after the window, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "lhbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

import torch  # noqa: E402

from lhbench import runner, spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if a.seed < 0:
        p.error("--seed must not be negative")
    cell = spec.cell(spec.load_benchmark(), a.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    run = runner.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                          torch.device("cuda", 0), STARTED)
    found = runner.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window", file=sys.stderr)
        return 3
    runner.emit(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
