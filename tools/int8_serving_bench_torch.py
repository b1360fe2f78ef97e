#!/usr/bin/env python3
"""Serving-path throughput of the PyTorch/CUDA port: the predict step
(``lighthand_tpu_torch/train/step.py:make_predict_step``) of HRNet-W32 at
256x256, bs128, under the bf16 and the int8_fwd policies, on one NVIDIA
GPU. The counterpart of ``tools/int8_serving_bench.py``, with its counts,
images and timing rule (pipelined timing, cross-checked by a blocked
floor).

    python3 tools/int8_serving_bench_torch.py     # needs one card

The predict step runs as a CUDA graph (``lighthand_tpu_torch/train/
graph.py``): the first warm-up call runs eagerly, the second captures, the
measured calls replay.

``#`` lines give the card's name and power limit, each precision's img/s
and its device ms a call (CUDA events around the pipelined calls). The last
line is ``{"bf16": img/s, "int8_fwd": img/s, "speedup": int8 / bf16}``.
Under int8_fwd a forward makes one grouped weight-quantize launch and one
int8 conv launch a quantized conv (``csrc/int8_conv.cu``). Without a card
it raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_torch import card_line, policy_for, time_calls  # noqa: E402
from lighthand_tpu_torch.core.device import resolve_device  # noqa: E402
from lighthand_tpu_torch.models import get_model  # noqa: E402
from lighthand_tpu_torch.train import (  # noqa: E402
    create_train_state,
    make_predict_step,
)

WARMUP, MEASURE, BLOCKED = 5, 30, 5


@dataclasses.dataclass
class Serving:
    img_per_sec: float
    device_ms: float | None  # events a call over the pipelined calls
    joints: torch.Tensor     # the last call's predictions [B, J, 2]


def measure_predict(precision: str, batch: int = 128, size: int = 256,
                    model_name: str = "hrnet_w32", device=None,
                    warmup: int = WARMUP, measure: int = MEASURE,
                    blocked: int = BLOCKED) -> Serving:
    """The predict step on ``rng.normal`` f32 images (``default_rng(0)``),
    the model's weights from a seeded generator, timed by
    ``bench_torch.time_calls``."""
    device = resolve_device(device)
    state = create_train_state(
        get_model(model_name, policy=policy_for(precision)),
        torch.Generator().manual_seed(0), device=device)
    predict = make_predict_step(stride=4.0, device=device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(batch, size, size, 3)).astype(
        np.float32)).to(device)
    t = time_calls(lambda: predict(state, images)[0], batch, device, warmup,
                   measure, blocked)
    return Serving(t.rate, t.event_ms, t.last)


def main(argv=None) -> int:
    del argv
    device = resolve_device(None)
    print(f"# {card_line()}", flush=True)
    out = {}
    for precision in ("bf16", "int8_fwd"):
        m = measure_predict(precision, device=device)
        if not bool(torch.isfinite(m.joints).all()):
            raise RuntimeError(f"non-finite {precision} predictions")
        out[precision] = round(m.img_per_sec, 2)
        dev_ms = ("not measured" if m.device_ms is None
                  else f"{m.device_ms:.3f}")
        print(f"# predict hrnet_w32@256 bs128 {precision}: "
              f"{out[precision]} img/s; {dev_ms} device ms a call (events)",
              flush=True)
    out["speedup"] = round(out["int8_fwd"] / out["bf16"], 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
