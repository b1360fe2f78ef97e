"""The program under test, built as its users build it, with the
benchmark's seeded weights: the only module of the harness that names the
port's entry points."""

from __future__ import annotations

import torch

from lhbench import inputs

PRECISIONS = ("bf16", "f32", "int8_fwd")


def policy(precision: str):
    """The port's dtype policy of a precision name, as its CLIs map it."""
    from lighthand_tpu_torch.core.dtypes import DTypePolicy

    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return {"bf16": DTypePolicy(), "f32": DTypePolicy.full_precision(),
            "int8_fwd": DTypePolicy.int8_fwd()}[precision]


def numerics(pol):
    from lighthand_tpu_torch.core.dtypes import numerics as ctx
    return ctx(pol)


def train_state(config: dict, pol, values: dict, lr: float,
                device: torch.device):
    """The port's model for ``config`` under ``pol``, built on the meta
    device (no host init), given ``values`` on ``device``, with Adam
    attached by ``create_train_state`` (``channels_last`` on the card)."""
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train.state import create_train_state

    with torch.device("meta"):
        model = get_model(config["model"], config["num_joints"], policy=pol)
    model.to_empty(device=device)
    inputs.load_program(model, values)
    return create_train_state(model, lr=lr, device=device)
