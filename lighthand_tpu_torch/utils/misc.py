"""Seeding: counterpart of ``lighthand_tpu/utils/misc.py:set_seed``."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs (``random``, numpy's global state) and return a
    CPU ``torch.Generator`` seeded with ``seed``; the reference seeds
    torch/cuda/np/random with 9001 (train.py:15-22)."""
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)
