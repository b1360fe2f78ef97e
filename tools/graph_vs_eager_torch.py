#!/usr/bin/env python3
"""The port's train step as CUDA graphs against its eager form, on one
NVIDIA GPU: ``bench_torch``'s fused step (bf16, 256x256, 4 microbatches a
dispatch) for HRNet-W32 at bs32 and bs128 and SimpleBaseline ResNet-50 at
bs32, each mode in a fresh process, then ``bench_torch.py``'s headline in
fresh processes.

    python3 tools/graph_vs_eager_torch.py [--bench-runs 3]   # needs a card

For each cell and mode (``graphed``: the step as built; ``eager``: its
``.eager`` form) it prints one ``CELL`` JSON line:

- ``event_ms``: CUDA events a dispatch over ``bench_torch.time_calls``'s
  pipelined dispatches (after 2 warm-up dispatches: the first of a shape
  runs eagerly, the second captures), ``wall_ms`` the host clock over the
  same window, ``img_per_sec`` the bench's rate;
- ``kernel_ms``: the profiler's kernel sum a dispatch over 2 more
  dispatches (``tools/profile_step_torch.py:summarize``, which also
  counts graph launches); ``busy_wall``, that sum over ``wall_ms``: the
  device's busy share in the unprofiled window; ``busy_profiled``, the
  sum over the profiled window's own host-clock time a dispatch (the
  profiler's host cost stretches an eager dispatch);
- ``peak_gib``: ``torch.cuda.max_memory_allocated`` from set-up on, the
  graphs' pool included.

Then each headline run's img/s, their mean and their spread ((max - min)
/ mean). The first line is the card's name and power limit (nvidia-smi);
the last is one JSON object with every figure. Traces go to
``lh_trace_torch/graph_vs_eager/`` (git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CELLS = (("hrnet_w32", 32), ("hrnet_w32", 128), ("resnet50", 32))
MODES = ("eager", "graphed")
SIZE, SCAN = 256, 4
WARMUP, MEASURE, BLOCKED, PROFILED = 2, 8, 3, 2
TRACES = os.path.join(REPO, "lh_trace_torch", "graph_vs_eager")


def one(model_name: str, batch: int, mode: str) -> dict:
    """One cell in one mode, in this process."""
    import torch

    import bench_torch
    from lighthand_tpu_torch.core.dtypes import numerics
    import profile_step_torch as profile

    device = bench_torch.resolve_device(None)
    torch.cuda.reset_peak_memory_stats(device)
    wl = bench_torch.setup(model_name, batch, SIZE, "bf16", SCAN,
                           device=device)
    if mode == "eager":
        wl.step = wl.step.eager
    with numerics(wl.policy):
        t = bench_torch.time_calls(wl.dispatch, wl.images_per_dispatch,
                                   device, WARMUP, MEASURE, BLOCKED)
    out_dir = os.path.join(TRACES, f"{model_name}_bs{batch}_{mode}")
    os.makedirs(out_dir, exist_ok=True)
    window = profile.trace_workload(wl, out_dir, PROFILED, {
        "model": model_name, "batch": batch, "size": SIZE,
        "precision": "bf16", "scan_steps": SCAN})
    summary = profile.summarize(out_dir, top_k=5)
    wall = window["wall_ms"] / PROFILED
    return {"model": model_name, "batch": batch, "mode": mode,
            "graphed": wl.step.graphs is not None,
            "event_ms": t.event_ms, "wall_ms": t.wall_ms,
            "img_per_sec": t.rate, "kernel_ms": summary["kernel_ms"],
            "busy_wall": summary["kernel_ms"] / t.wall_ms,
            "busy_profiled": summary["kernel_ms"] / wall,
            "kernels_per_dispatch": summary["kernels"],
            "graph_launches": summary["graph_launches"] / PROFILED,
            "dropped": summary["dropped"],
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
            "loss": float(t.last)}


def _last_json(text: str, key: str) -> dict:
    for line in reversed(text.splitlines()):
        if line.startswith(key):
            return json.loads(line[len(key):])
    raise RuntimeError(f"no {key!r} line in:\n{text[-3000:]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bench-runs", type=int, default=3)
    p.add_argument("--one", nargs=3, metavar=("MODEL", "BATCH", "MODE"),
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.one:
        print("CELL " + json.dumps(one(a.one[0], int(a.one[1]), a.one[2])),
              flush=True)
        return 0
    from bench_torch import card_line

    card = card_line()
    print(f"# {card}", flush=True)
    cells = []
    for model_name, batch in CELLS:
        for mode in MODES:
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 model_name, str(batch), mode], cwd=REPO,
                capture_output=True, text=True, timeout=900)
            if run.returncode != 0:
                print(run.stdout[-3000:], run.stderr[-3000:])
                raise RuntimeError(f"{model_name} bs{batch} {mode} exited "
                                   f"{run.returncode}")
            cell = _last_json(run.stdout, "CELL ")
            cells.append(cell)
            print(f"# {model_name}@{SIZE} bs{batch} bf16 K={SCAN} {mode}: "
                  f"{cell['event_ms']:.2f} ms a dispatch (events), "
                  f"{cell['wall_ms']:.2f} ms (host), "
                  f"{cell['img_per_sec']:.2f} img/s; kernels "
                  f"{cell['kernel_ms']:.2f} ms a dispatch, busy "
                  f"{cell['busy_wall']:.4f} of the wall "
                  f"({cell['busy_profiled']:.4f} of the profiled wall), "
                  f"{cell['kernels_per_dispatch']:.0f} kernels and "
                  f"{cell['graph_launches']:.0f} graph launches a dispatch, "
                  f"peak {cell['peak_gib']:.2f} GiB", flush=True)
            print("CELL " + json.dumps(cell), flush=True)
    heads = []
    for i in range(a.bench_runs):
        run = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-3000:], run.stderr[-3000:])
            raise RuntimeError(f"bench_torch.py run {i} exited "
                               f"{run.returncode}")
        heads.append(json.loads(run.stdout.strip().splitlines()[-1])["value"])
        print(f"# bench_torch.py headline run {i + 1}: {heads[-1]} img/s",
              flush=True)
    spread = None
    if heads:
        mean = statistics.mean(heads)
        spread = (max(heads) - min(heads)) / mean
        print(f"# headline over {len(heads)} fresh processes: mean "
              f"{mean:.2f} img/s, spread {100 * spread:.2f} % ((max - min) "
              "/ mean)", flush=True)
    print(json.dumps({"device": card, "cells": cells, "headline": heads,
                      "headline_spread": spread}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
