#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: training images/sec for HRNet-W32 @
256x256 heatmap regression on one NVIDIA GPU, with the port's fused train
step: u8 batch in -> K1 (per-sample color jitter, ImageNet normalize to
bf16, MSRA Gaussian targets; ``csrc/fused_aug.cu``) -> forward/backward ->
Adam, 4 pre-staged microbatches a dispatch (what ``cli.train
--steps-per-dispatch 4`` runs). The counterpart of ``bench.py``, whose
constants, batch and timing rule it copies.

    python3 bench_torch.py          # the headline; needs one card
    python3 bench_torch.py --all    # and bench.py's EXTRA_CONFIGS, into
                                    # BENCH_TABLE_torch.json

The step runs as CUDA graphs (``lighthand_tpu_torch/train/graph.py``), as
the JAX bench's step is a jitted program: of the ``WARMUP`` dispatches the
first runs its first microbatch eagerly and captures the second, so the
measured dispatches replay (Adam eagerly after each microbatch).

Earlier ``#`` lines give the card's name and power limit (``nvidia-smi``),
the headline's device ms a dispatch (CUDA events around the measured
dispatches), the share of the wall window those events span, and the peak
device memory. The last line is one JSON object with ``bench.py``'s keys:
``metric``, ``value``, ``unit``, ``vs_baseline``. Without a card it raises;
there is no CPU run from the command line (tests call ``measure`` with
``device="cpu"``).

``REFERENCE_IMG_PER_SEC`` (330 img/s) is the JAX round's *estimate* of the
PyTorch reference's throughput on an A100-class GPU (HRNet-W32@256, bs32,
fp32 + cudnn.benchmark, with its per-step host sync), not a measurement and
not a TPU figure; ``vs_baseline`` = value / 330. ``REF_ESTIMATES`` scale
that estimate by each configuration's convolution bytes (``bench.py``'s
table; ``tools/conv_bytes.py``). ``--all`` writes ``BENCH_TABLE_torch.json``
and never ``BENCH_TABLE.json``, which holds the JAX bench's figures.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.train import create_train_state, make_fused_train_step
from lighthand_tpu_torch.train.state import TrainState

# copied from bench.py:29-66 (a test holds them equal)
REFERENCE_IMG_PER_SEC = 330.0  # estimate: torch HRNet-W32@256 bs32 on A100

BATCH = 128
SCAN_STEPS = 4     # optimizer steps per dispatch
SIZE = 256
WARMUP = 2
MEASURE = 8        # dispatches; = MEASURE * SCAN_STEPS optimizer steps

# bench.py's configurations beyond the headline (model, batch, size,
# precision, target style): SimpleBaseline at 256 and at 224 (the
# reference's bs32 and bs256), HRNet-W48, HRNet-W32 under all_bf16 and
# int8_fwd, and the multi-dataset mix's per-sample target route.
EXTRA_CONFIGS = [
    ("simplebaseline", 256, 256, "bf16", "msra"),
    ("simplebaseline", 32, 224, "bf16", "msra"),
    ("simplebaseline", 256, 224, "bf16", "msra"),
    ("hrnet_w48", 64, 256, "bf16", "msra"),
    ("hrnet_w32", 128, 256, "all_bf16", "msra"),
    ("hrnet_w32", 128, 256, "int8_fwd", "msra"),
    ("simplebaseline", 256, 256, "bf16", "per_sample"),
]

# Per-config reference estimates (img/s): 330 x (HRNet-W32 conv bytes /
# config conv bytes), BASELINE.md "Per-config reference estimates".
REF_ESTIMATES = {
    ("hrnet_w32", 256): 330.0,
    ("simplebaseline", 224): 669.0,
    ("simplebaseline", 256): 531.0,
    ("hrnet_w48", 256): 237.0,
}

BLOCKED = 3  # dispatches of the blocked floor (bench.py:138-149)
TABLE = "BENCH_TABLE_torch.json"
LR = 1e-3


def policy_for(precision: str) -> DTypePolicy:
    """The policy of a precision name, as the training CLI maps it."""
    policies = {"bf16": DTypePolicy(), "all_bf16": DTypePolicy.all_bf16(),
                "int8_fwd": DTypePolicy.int8_fwd(),
                "f32": DTypePolicy.full_precision()}
    if precision not in policies:
        raise ValueError(f"precision must be one of {sorted(policies)}, got "
                         f"{precision!r}")
    return policies[precision]


def make_batch(scan_steps: int, batch: int, size: int,
               target_style: str = "msra") -> dict:
    """bench.py's batch (``bench.py:98-119``), the same ``default_rng(0)``
    calls in the same order, as numpy arrays [K, B, ...]."""
    rng = np.random.default_rng(0)
    out = {
        "image_u8": rng.integers(0, 255, size=(scan_steps, batch, size, size,
                                               3), dtype=np.uint8),
        "joints": rng.uniform(16, size - 16, size=(scan_steps, batch, 21, 2))
        .astype(np.float32),
        "aug_enabled": np.ones((scan_steps, batch), np.float32),
        "noise_enabled": np.zeros((scan_steps, batch), np.float32),
    }
    if target_style == "per_sample":
        # the mix route: half the batch takes max-combine targets
        out["hm_max"] = (rng.uniform(size=(scan_steps, batch)) < 0.5).astype(
            np.float32)
    return out


@dataclasses.dataclass
class Workload:
    """One configuration's train state, fused step and pre-staged batch."""
    state: TrainState
    step: Callable
    batch: dict
    generator: torch.Generator
    policy: DTypePolicy
    device: torch.device
    images_per_dispatch: int

    def dispatch(self) -> torch.Tensor:
        """One call of the step (``scan_steps`` optimizer steps); returns
        the loss without synchronising."""
        self.state, metrics = self.step(self.state, self.generator, self.batch)
        return metrics["loss"]


def setup(model_name: str, batch: int, size: int, precision: str = "bf16",
          scan_steps: int = SCAN_STEPS, target_style: str = "msra",
          device=None) -> Workload:
    """The model from a seeded generator (the counterpart of
    ``cpu_prng_key(0)``), Adam at lr 1e-3, laid out as the CLI lays it out
    (``channels_last`` on the card), the fused step with the CLI's
    arguments and ``make_batch``'s batch on the device (without the K axis
    when ``scan_steps`` is 1); the step's generator is seeded 1."""
    device = resolve_device(device)
    policy = policy_for(precision)
    state = create_train_state(get_model(model_name, policy=policy),
                               torch.Generator().manual_seed(0), lr=LR,
                               device=device)
    step = make_fused_train_step(heatmap_size=size // 4, stride=4.0,
                                 jitter=True, scan_steps=scan_steps,
                                 target_style=target_style,
                                 compute_dtype=policy.compute_dtype,
                                 device=device)
    staged = {k: torch.from_numpy(v[0] if scan_steps == 1 else v).to(device)
              for k, v in make_batch(scan_steps, batch, size,
                                     target_style).items()}
    return Workload(state, step, staged,
                    torch.Generator(device=device).manual_seed(1), policy,
                    device, scan_steps * batch)


@dataclasses.dataclass
class Timing:
    rate: float              # items/s: the pipelined figure unless implausible
    pipelined_rate: float
    blocked_rate: float
    event_ms: float | None   # CUDA events a call over the pipelined calls
    wall_ms: float           # host clock a call over the same calls
    last: object             # what the last call returned


def time_calls(call: Callable, items: int, device: torch.device,
               warmup: int, measure: int, blocked: int) -> Timing:
    """``bench.py``'s timing of ``call`` (``items`` a call): ``warmup``
    calls, then ``measure`` calls with one synchronisation at the end (host
    clock, with CUDA events around the same window on the card), then the
    blocked floor (``blocked`` calls, each synchronised). The pipelined
    rate stands unless it is above 1.3x the blocked one."""
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        last = call()
    sync()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(measure):
        last = call()
    if cuda:
        end.record()
    sync()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(blocked):
        last = call()
        sync()
    pipelined = measure * items / wall
    floor = blocked * items / (time.perf_counter() - t0)
    rate = pipelined
    if pipelined > 1.3 * floor:
        print(f"# WARNING: pipelined timing implausible ({pipelined:.0f} vs "
              f"blocked {floor:.0f} a second); reporting the blocked "
              "measurement", flush=True)
        rate = floor
    return Timing(rate, pipelined, floor,
                  start.elapsed_time(end) / measure if cuda else None,
                  wall * 1e3 / measure, last)


@dataclasses.dataclass
class Measurement:
    img_per_sec: float       # wall clock, what a user waits for
    pipelined_img_per_sec: float
    blocked_img_per_sec: float
    device_ms: float | None  # CUDA events a dispatch, measured window
    events_over_wall: float | None
    peak_bytes: int | None   # torch.cuda.max_memory_allocated
    loss: float


def measure(model_name: str, batch: int, size: int, precision: str = "bf16",
            scan_steps: int = SCAN_STEPS, measure: int = MEASURE,
            target_style: str = "msra", device=None, warmup: int = WARMUP,
            blocked: int = BLOCKED) -> Measurement:
    """``setup``'s workload timed by ``time_calls`` a dispatch, inside the
    policy's numerics, with the peak device memory of set-up and run."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    wl = setup(model_name, batch, size, precision, scan_steps, target_style,
               device)
    with numerics(wl.policy):
        t = time_calls(wl.dispatch, wl.images_per_dispatch, device, warmup,
                       measure, blocked)
    return Measurement(
        img_per_sec=t.rate, pipelined_img_per_sec=t.pipelined_rate,
        blocked_img_per_sec=t.blocked_rate, device_ms=t.event_ms,
        events_over_wall=None if t.event_ms is None else (
            t.event_ms / t.wall_ms),
        peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
        loss=float(t.last))


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, or why there is none."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {smi.stderr.strip()}"


def describe(m: Measurement) -> str:
    """The device figures of a measurement, for a ``#`` line."""
    if m.device_ms is None:
        return "device ms not measured"
    return (f"{m.device_ms:.2f} device ms a dispatch (events), events span "
            f"{100 * m.events_over_wall:.1f} % of the wall window, peak "
            f"memory {m.peak_bytes / 2**30:.2f} GiB")


def _row(model_name: str, size: int, m: Measurement) -> dict:
    ref = REF_ESTIMATES[(model_name, size)]
    return {"img_per_sec": round(m.img_per_sec, 2), "ref_estimate": ref,
            "vs_ref": round(m.img_per_sec / ref, 2),
            "device_ms_per_dispatch": (None if m.device_ms is None
                                       else round(m.device_ms, 3)),
            "peak_gib": (None if m.peak_bytes is None
                         else round(m.peak_bytes / 2**30, 3))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--all", action="store_true",
                   help="also run EXTRA_CONFIGS into " + TABLE)
    a = p.parse_args(argv)
    device = resolve_device(None)
    card = card_line()
    print(f"# {card}", flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    head = measure("hrnet_w32", BATCH, SIZE, "bf16", device=device)
    ips = head.img_per_sec
    print(f"# hrnet_w32@{SIZE} bs{BATCH} bf16 (headline): {ips:.2f} img/s; "
          f"{describe(head)}", flush=True)
    if a.all:
        table = {f"hrnet_w32@{SIZE} bs{BATCH} bf16":
                 _row("hrnet_w32", SIZE, head)}
        for model_name, batch, size, precision, style in EXTRA_CONFIGS:
            gc.collect()
            torch.cuda.empty_cache()
            m = measure(model_name, batch, size, precision,
                        target_style=style, device=device)
            key = f"{model_name}@{size} bs{batch} {precision}"
            if style != "msra":
                key += f" {style}(mix)"
            table[key] = _row(model_name, size, m)
            print(f"# {key}: {m.img_per_sec:.2f} img/s "
                  f"({table[key]['vs_ref']}x ref); {describe(m)}",
                  flush=True)
        table["_ref_method"] = (
            "ref_estimate = 330 x (hrnet_w32 conv bytes / config conv "
            "bytes), tools/conv_bytes.py; BASELINE.md 'Per-config "
            "reference estimates (round 5)'")
        table["_device"] = card
        with open(TABLE, "w") as f:
            json.dump(table, f, indent=1)
    if not math.isfinite(head.loss):
        raise RuntimeError(f"the headline's loss is not finite: {head.loss}")
    print(json.dumps({
        "metric": f"train images/sec/chip (HRNet-W32@256^2, bs{BATCH}, "
                  f"bf16, scan{SCAN_STEPS}, incl. on-device "
                  "aug+heatmap-target)",
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / REFERENCE_IMG_PER_SEC, 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
