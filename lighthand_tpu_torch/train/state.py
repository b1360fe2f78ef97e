"""Train state: the model, Adam and a step count; cosine LR per epoch.

Counterpart of ``lighthand_tpu/train/state.py``: torch.optim.Adam with the
torch defaults (betas 0.9/0.999, eps 1e-8, which equal ``optax.adam``'s)
and CosineAnnealingLR's closed form stepped once per epoch (reference
src/tools/train.py:45-58,117).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.models.layers import init_weights


def cosine_lr(base_lr: float, epoch: int, t_max: int,
              eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR closed form: eta_min + (base - eta_min) *
    (1 + cos(pi * epoch / T_max)) / 2."""
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / t_max)) / 2


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    device: torch.device
    step: int = 0


def create_train_state(model: nn.Module,
                       generator: torch.Generator | None = None,
                       lr: float = 1e-3,
                       device: str | torch.device | None = None) -> TrainState:
    """Move ``model`` to ``device`` (``cuda`` unless the caller says
    ``"cpu"``; ``channels_last`` on the card) and attach Adam. With a
    ``generator`` the weights are first drawn anew from it (torch's default
    init), so a seed gives the same model on any device."""
    device = resolve_device(device)
    if generator is not None:
        init_weights(model, generator)
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    return TrainState(model=model, optimizer=optimizer, device=device)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the LR (host-side, once per epoch)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
