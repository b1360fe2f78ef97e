"""Checkpointing: best-only retention with ``torch.save``.

Counterpart of ``lighthand_tpu/train/checkpoint.py`` (reference
src/tools/dataset.py:340-367 ``save_checkpoint`` and src/utils/dir.py:38-47
``resume_checkpoint``): the five logical fields {epoch, optimizer state,
best_loss, early-stop count, model state} plus the step count, written to
``{output_dir}/checkpoint-good/state.pt``; resume restores them and
continues at epoch + 1. Loading checkpoints written by the JAX package
(orbax) is not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from lighthand_tpu_torch.train.state import TrainState

CKPT_DIR_NAME = "checkpoint-good"  # "good" = best model (train.py:99-108)
STATE_FILE = "state.pt"


def _ckpt_path(output_dir: str, ment: str = "good") -> str:
    return os.path.abspath(os.path.join(output_dir, f"checkpoint-{ment}"))


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
    the checkpoint itself."""
    path = _ckpt_path(output_dir, ment)
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "best_loss": float(best_loss),
        "count": int(count),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    marker = {"epoch": int(epoch), "path": path}
    if model_info:
        marker["model"] = dict(model_info)
    with open(os.path.join(output_dir, "last_checkpoint.json"), "w") as f:
        json.dump(marker, f)
    return path


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


def _load(state: TrainState, checkpoint_dir: str) -> dict:
    return torch.load(os.path.join(checkpoint_dir, STATE_FILE),
                      map_location=state.device, weights_only=True)


def resume_checkpoint(
    state: TrainState,
    output_dir: str,
    ment: str = "good",
    restore_optimizer: bool = True,
) -> Tuple[float, int, TrainState, int]:
    """Returns (best_loss, start_epoch, state, count); start_epoch is the
    stored epoch + 1 (dir.py:41). ``restore_optimizer=False`` is the
    reference's ``--optim`` flag (train.py:50): Adam starts anew."""
    payload = _load(state, _ckpt_path(output_dir, ment))
    state.model.load_state_dict(payload["model"])
    state.step = payload["step"]
    if restore_optimizer:
        state.optimizer.load_state_dict(payload["optimizer"])
    return (payload["best_loss"], payload["epoch"] + 1, state,
            payload["count"])


def load_weights_only(state: TrainState, checkpoint_dir: str) -> TrainState:
    """Warm-start the model from another run: the ``--transfer`` path
    (argparser.py:167-187 loads output/{model}/frei/ori)."""
    payload = _load(state, os.path.abspath(checkpoint_dir))
    state.model.load_state_dict(payload["model"])
    return state
