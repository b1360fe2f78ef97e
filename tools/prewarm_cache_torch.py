#!/usr/bin/env python3
"""Prewarm the port's decoded-crop cache (``lighthand_tpu_torch/data/
cache.py``) and measure the speedup: the counterpart of
``tools/prewarm_cache.py``.

Usage (the training CLI's dataset flags):
    python3 tools/prewarm_cache_torch.py --root simplebaseline/ours \
        --name x --num_our 20000 --dataset-root _data [--batch 256]

Runs on the host only and never initialises CUDA: the fill pass decodes
every sample through the port's codec into the memmap, the cached pass reads
it back, and the printed rates are the host feed before and after. Run it
before a training job so that the job's first epoch reads every crop from
the cache. The port's cache lives in its own directory, apart from the JAX
package's (``data/cache.py:PORT_TAG``).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lighthand_tpu_torch.config import parse_args  # noqa: E402
from lighthand_tpu_torch.data.registry import build_dataset  # noqa: E402


def sweep(source, batch: int, label: str) -> float:
    t0 = time.monotonic()
    n = len(source)
    for lo in range(0, n, batch):
        source.getitems(range(lo, min(lo + batch, n)))
        done = min(lo + batch, n)
        if lo and lo % (batch * 16) == 0:
            rate = done / (time.monotonic() - t0)
            print(f"  {label}: {done}/{n} ({rate:.0f} samples/s)",
                  flush=True)
    dt = time.monotonic() - t0
    rate = n / dt
    print(f"{label}: {n} samples in {dt:.1f}s = {rate:.0f} samples/s",
          flush=True)
    return rate


def main(argv=None) -> int:
    batch = 256
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--batch" in argv:
        i = argv.index("--batch")
        batch = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    cfg = parse_args(argv)
    for name, src in zip(("train", "val"), build_dataset(cfg)):
        kind = type(src).__name__
        print(f"{name}: {kind}, {len(src)} samples")
        # the frei/gan routes wrap the CachedSource in a SubsetSource
        # (random_split_90_10): sweeping the subset fills the memmap
        # through SubsetSource.getitems
        inner = src
        while not hasattr(inner, "cache_dir") and hasattr(inner, "base"):
            inner = inner.base
        if not hasattr(inner, "cache_dir"):
            print("  (not cached — skipping)")
            continue
        print(f"  cache dir {inner.cache_dir}, "
              f"{inner.hit_fraction() * 100:.1f}% filled")
        fill = sweep(src, batch, f"{name} fill/verify pass")
        cached = sweep(src, batch, f"{name} cached pass")
        print(f"{name}: cached/fill speedup = {cached / fill:.1f}x",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
