"""Misc utilities: counterpart of ``lighthand_tpu/utils/misc.py`` (reference
src/utils/miscellaneous.py:15-169: mkdir, yaml config io, freeze_weights by
regex, set_seed, try_once).

Freezing is the reference's own, ``requires_grad=False`` on the parameters
whose ``state_dict`` names match a pattern, with an Adam over the others
(``masked_optimizer``): the JAX package's ``optax.multi_transform`` with
``set_to_zero``. JAX matches ``/``-joined Flax paths; the port matches the
reference's torch names, which its modules keep.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import random
import re
from typing import Any, Callable

import numpy as np
import torch
import yaml
from torch import nn


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs (``random``, numpy's global state) and return a
    CPU ``torch.Generator`` seeded with ``seed``; the reference seeds
    torch/cuda/np/random with 9001 (train.py:15-22)."""
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)


def save_config(cfg: Any, output_dir: str, name: str = "config.yaml") -> str:
    """``cfg`` (a dataclass or a mapping) as YAML in ``output_dir``; returns
    the file's path."""
    mkdir(output_dir)
    path = os.path.join(output_dir, name)
    payload = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    with open(path, "w") as f:
        yaml.safe_dump(payload, f)
    return path


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def freeze_mask(model: nn.Module, patterns: list[str]) -> dict[str, bool]:
    """{parameter name: trainable} over ``model.named_parameters()``: False
    where the name matches any regex of ``patterns`` (``re.search``), as the
    reference's ``freeze_weights`` matched them. BatchNorm running stats
    are buffers, not parameters: they keep updating in train mode, as
    Flax's ``batch_stats`` do. Use with ``masked_optimizer``."""
    regexes = [re.compile(p) for p in patterns]
    return {name: not any(r.search(name) for r in regexes)
            for name, _ in model.named_parameters()}


def masked_optimizer(model: nn.Module, trainable_mask: dict[str, bool],
                     lr: float = 1e-3) -> torch.optim.Adam:
    """Adam (``train/state.py:make_optimizer``) over the trainable
    parameters only; the frozen ones get ``requires_grad_(False)``, so
    backward leaves their ``.grad`` None: they never change, keep no Adam
    moments, and no step gathers or averages a gradient for them.
    ``trainable_mask`` must name every parameter of ``model``."""
    # train/state.py imports this module
    from lighthand_tpu_torch.train.state import make_optimizer

    named = dict(model.named_parameters())
    if set(trainable_mask) != set(named):
        unknown = sorted(set(trainable_mask) - set(named))
        absent = sorted(set(named) - set(trainable_mask))
        raise ValueError(f"trainable_mask does not match the model's "
                         f"parameters: unknown {unknown[:5]}, absent "
                         f"{absent[:5]}")
    for name, p in named.items():
        p.requires_grad_(bool(trainable_mask[name]))
    trainable = [p for p in named.values() if p.requires_grad]
    if not trainable:
        raise ValueError("trainable_mask freezes every parameter")
    return make_optimizer(trainable, lr)


def try_once(fn: Callable) -> Callable:
    """Swallow-and-log error decorator (miscellaneous.py:135-146)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — by design
            print(f"[try_once] {fn.__name__} failed: {e}")
            return None

    return wrapper


def config_iteration(output_dir: str) -> int:
    """The last checkpointed epoch of a run directory, from the
    ``last_checkpoint.json`` that ``train/checkpoint.py`` writes (0 where
    there is none)."""
    marker = os.path.join(output_dir, "last_checkpoint.json")
    if not os.path.isfile(marker):
        return 0
    with open(marker) as f:
        return int(json.load(f).get("epoch", 0))
