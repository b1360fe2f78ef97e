"""Checkpointing: best-only retention with ``torch.save``.

Counterpart of ``lighthand_tpu/train/checkpoint.py`` (reference
src/tools/dataset.py:340-367 ``save_checkpoint`` and src/utils/dir.py:38-47
``resume_checkpoint``): the five logical fields {epoch, optimizer state,
best_loss, early-stop count, model state} plus the step count, written to
``{output_dir}/checkpoint-good/state.pt``; resume restores them and
continues at epoch + 1.

The state is saved whole, on the CPU, through
``get_state_dict(full_state_dict=True, cpu_offload=True)``, in one process
or sharded (``core/mesh.py:shard_model``): there every process joins and
rank 0 alone writes (``lighthand_tpu/train/checkpoint.py:85``). The
optimizer state is keyed by parameter index, as
``Optimizer.state_dict()`` keys it. Every process loads it through
``set_model_state_dict`` / ``set_optimizer_state_dict``. So a checkpoint
from any mesh resumes on any other mesh and in one process, and
``cli.eval`` reads it. A run of the JAX package (orbax) is converted into
this layout by ``tools/orbax_to_torch.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from lighthand_tpu_torch.core.mesh import is_host_leader
from lighthand_tpu_torch.train.state import TrainState

CKPT_DIR_NAME = "checkpoint-good"  # "good" = best model (train.py:99-108)
STATE_FILE = "state.pt"


def _ckpt_path(output_dir: str, ment: str = "good") -> str:
    return os.path.abspath(os.path.join(output_dir, f"checkpoint-{ment}"))


def _full_options():
    from torch.distributed.checkpoint.state_dict import StateDictOptions

    return StateDictOptions(full_state_dict=True, cpu_offload=True)


def _optimizer_by_index(model, optim: dict) -> dict:
    """An FQN-keyed optimizer state (``get_state_dict``) in
    ``Optimizer.state_dict()``'s layout: parameters by their index in
    ``model.parameters()``, which is the order Adam was built in."""
    if not optim:
        return optim
    pos = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    return {"state": {pos[k]: v for k, v in optim["state"].items()},
            "param_groups": [{**g, "params": [pos[n] for n in g["params"]]}
                             for g in optim["param_groups"]]}


def _optimizer_by_name(model, optim: dict) -> dict:
    names = [name for name, _ in model.named_parameters()]
    return {"state": {names[i]: v for i, v in optim["state"].items()},
            "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                             for g in optim["param_groups"]]}


def _state_dicts(state: TrainState) -> tuple[dict, dict]:
    """(model, optimizer) state dicts, whole, on the CPU; a sharded model's
    are gathered by every process and kept by rank 0 (empty elsewhere)."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.model, state.optimizer,
                                        options=_full_options())
    return model_sd, _optimizer_by_index(state.model, optim_sd)


def save_checkpoint(
    state: TrainState,
    output_dir: str,
    epoch: int,
    best_loss: float,
    count: int,
    ment: str = "good",
    model_info: Optional[dict] = None,
) -> str:
    """Best-checkpoint save (src/tools/dataset.py:345). ``model_info`` (e.g.
    ``{"name": "hrnet", "precision": "bf16"}``) is recorded in
    ``last_checkpoint.json`` so a reader can recover the architecture from
    the checkpoint itself. In a process group every process calls it and
    rank 0 writes; the others wait until the file is there."""
    path = _ckpt_path(output_dir, ment)
    model_sd, optim_sd = _state_dicts(state)
    if is_host_leader():
        _write(path, output_dir, epoch, best_loss, count, model_sd, optim_sd,
               state.step, model_info)
    if dist.is_initialized():
        dist.barrier()
    return path


def _write(path, output_dir, epoch, best_loss, count, model_sd, optim_sd,
           step, model_info) -> None:
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_loss": float(best_loss),
        "count": int(count),
        "model": model_sd,
        "optimizer": optim_sd,
        "step": int(step),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    marker = {"epoch": int(epoch), "path": path}
    if model_info:
        marker["model"] = dict(model_info)
    with open(os.path.join(output_dir, "last_checkpoint.json"), "w") as f:
        json.dump(marker, f)


def read_model_info(checkpoint_dir: str) -> Optional[dict]:
    """The ``model_info`` recorded at save time for a checkpoint directory
    (from ``last_checkpoint.json`` beside it), or None where none was."""
    marker = os.path.join(os.path.dirname(os.path.abspath(checkpoint_dir)),
                          "last_checkpoint.json")
    try:
        with open(marker) as f:
            info = json.load(f).get("model")
        return dict(info) if isinstance(info, dict) else None
    except (OSError, ValueError):
        return None


def checkpoint_exists(output_dir: str, ment: str = "good") -> bool:
    return os.path.isfile(os.path.join(_ckpt_path(output_dir, ment),
                                       STATE_FILE))


def _load(checkpoint_dir: str) -> dict:
    # whole tensors on the CPU: each process copies (or shards) them in
    return torch.load(os.path.join(checkpoint_dir, STATE_FILE),
                      map_location="cpu", weights_only=True)


def _load_model(state: TrainState, model_sd: dict) -> None:
    from torch.distributed.checkpoint.state_dict import set_model_state_dict

    set_model_state_dict(state.model, dict(model_sd),
                         options=_full_options())


def _load_optimizer(state: TrainState, optim_sd: dict) -> None:
    from torch.distributed.checkpoint.state_dict import (
        set_optimizer_state_dict,
    )

    set_optimizer_state_dict(state.model, state.optimizer,
                             _optimizer_by_name(state.model, optim_sd),
                             options=_full_options())


def resume_checkpoint(
    state: TrainState,
    output_dir: str,
    ment: str = "good",
    restore_optimizer: bool = True,
) -> Tuple[float, int, TrainState, int]:
    """Returns (best_loss, start_epoch, state, count); start_epoch is the
    stored epoch + 1 (dir.py:41). ``restore_optimizer=False`` is the
    reference's ``--optim`` flag (train.py:50): Adam starts anew."""
    payload = _load(_ckpt_path(output_dir, ment))
    _load_model(state, payload["model"])
    state.step = payload["step"]
    if restore_optimizer:
        _load_optimizer(state, payload["optimizer"])
    return (payload["best_loss"], payload["epoch"] + 1, state,
            payload["count"])


def load_weights_only(state: TrainState, checkpoint_dir: str) -> TrainState:
    """Warm-start the model from another run: the ``--transfer`` path
    (argparser.py:167-187 loads output/{model}/frei/ori)."""
    payload = _load(os.path.abspath(checkpoint_dir))
    _load_model(state, payload["model"])
    return state
