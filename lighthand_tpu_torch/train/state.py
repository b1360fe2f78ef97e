"""Train state: the model, Adam and a step count; cosine LR per epoch.

Counterpart of ``lighthand_tpu/train/state.py``: torch.optim.Adam with the
torch defaults (betas 0.9/0.999, eps 1e-8, which equal ``optax.adam``'s)
and CosineAnnealingLR's closed form stepped once per epoch (reference
src/tools/train.py:45-58,117).

A sharded model's parameters, gradients and moments are DTensors; Adam
steps their local shards (``ShardAdam``), so the sharded and the plain
model take one Adam arithmetic, with no DTensor dispatch per operation. At
model axis 1 the model is replicated, not sharded (``core/mesh.py``): its
parameters are plain, and the steps average its gradients over the data
axis (``TrainState.grad_group``).

On the card a train step's backward runs in a CUDA graph
(``train/graph.py``), which writes the gradients into its own static
tensors; it binds them to the parameters' ``.grad`` again after each
replay, so ``apply_gradients`` (Adam, eager) always reads the gradients
of the microbatch just replayed. Frozen parameters get none.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.mesh import (
    data_group,
    data_index,
    model_axis,
    replica_group,
    shard_model,
)
from lighthand_tpu_torch.models.layers import init_weights, set_batchnorm_group
from lighthand_tpu_torch.utils.misc import masked_optimizer


def cosine_lr(base_lr: float, epoch: int, t_max: int,
              eta_min: float = 0.0) -> float:
    """torch CosineAnnealingLR closed form: eta_min + (base - eta_min) *
    (1 + cos(pi * epoch / T_max)) / 2."""
    return eta_min + (base_lr - eta_min) * (
        1 + math.cos(math.pi * epoch / t_max)) / 2


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the tensor itself for a plain one). The
    attribute, not ``to_local()``: a step reads four lists of them (4 x
    878 for HRNet-W32), and the method's host cost per call showed in the
    step's time."""
    return getattr(t, "_local_tensor", t)


class ShardAdam(torch.optim.Adam):
    """``torch.optim.Adam`` that steps the local tensors of DTensor
    parameters: the same update (its per-tensor or ``foreach`` kernels, as
    torch picks them for the device) over the shards, in place. Its state
    keeps the DTensor moments, so checkpoints gather them whole as
    before."""

    def _init_group(self, group, params, grads, exp_avgs, exp_avg_sqs,
                    max_exp_avg_sqs, state_steps):
        has_complex = super()._init_group(group, params, grads, exp_avgs,
                                          exp_avg_sqs, max_exp_avg_sqs,
                                          state_steps)
        for seq in (params, grads, exp_avgs, exp_avg_sqs, max_exp_avg_sqs):
            seq[:] = [_local(t) for t in seq]
        return has_complex


def make_optimizer(params, lr: float = 1e-3) -> ShardAdam:
    """Adam with the torch defaults the reference uses (train.py:45-48) over
    ``params``; ``set_learning_rate`` sets the per-epoch cosine value."""
    return ShardAdam(params, lr=lr)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    device: torch.device
    step: int = 0
    # the group over which the steps average a replicated model's gradients
    # after backward (``core/mesh.py:average_gradients``); None in one
    # process, at data axis 1, and where FSDP2 shards the model
    grad_group: object = None

    def apply_gradients(self) -> "TrainState":
        """One optimizer step, then ``step += 1``; returns the state. The
        signature is torch's: backward leaves the gradients on the
        parameters and BatchNorm updates its running stats in the forward,
        where JAX's ``apply_gradients(grads, new_batch_stats)`` takes both
        as arguments and returns a new state."""
        self.optimizer.step()
        self.step += 1
        return self


def create_train_state(model: nn.Module,
                       generator: torch.Generator | None = None,
                       lr: float = 1e-3,
                       device: str | torch.device | None = None,
                       mesh=None,
                       trainable: dict[str, bool] | None = None
                       ) -> TrainState:
    """Move ``model`` to ``device`` (``cuda`` unless the caller says
    ``"cpu"``; ``channels_last`` on the card, unless sharded: FSDP2 shards
    contiguous parameters only) and attach Adam. With a
    ``generator`` the weights are first drawn anew from it (torch's default
    init), so a seed gives the same model on any device and in every
    process. Under ``mesh`` the model is sharded where the model axis is
    above 1 (``core/mesh.py:shard_model``, HSDP) and replicated at model
    axis 1, before Adam is built, and its BatchNorm layers normalise over
    the data axis (``models/layers.py:BatchNorm2d``). A ``trainable`` mask
    ({parameter name: bool}, ``utils/misc.py:freeze_mask``) freezes the
    parameters it maps to False (``masked_optimizer``)."""
    device = resolve_device(device)
    if generator is not None:
        init_weights(model, generator)
    model.to(device)
    if device.type == "cuda" and model_axis(mesh) == 1:
        model.to(memory_format=torch.channels_last)
    shard_model(model, mesh)
    set_batchnorm_group(model, data_group(mesh), data_index(mesh)[1])
    optimizer = (make_optimizer(model.parameters(), lr) if trainable is None
                 else masked_optimizer(model, trainable, lr))
    return TrainState(model=model, optimizer=optimizer, device=device,
                      grad_group=replica_group(mesh))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the LR (host-side, once per epoch)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def param_count(state: TrainState) -> int:
    """Elements of every parameter, frozen ones included (a sharded
    parameter counts whole)."""
    return sum(p.numel() for p in state.model.parameters())
