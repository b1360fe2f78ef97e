#!/usr/bin/env python3
"""Convert a training run of the JAX package (orbax checkpoint) into the
PyTorch port's checkpoint layout.

    python tools/orbax_to_torch.py RUN_DIR OUT_DIR [--ment good] [--model NAME]

RUN_DIR is a run directory of ``lighthand_tpu.cli.train`` (it holds
``checkpoint-good/`` and ``last_checkpoint.json``). OUT_DIR receives the
port's ``checkpoint-good/state.pt`` and ``last_checkpoint.json``, so
``lighthand_tpu_torch.cli.train`` resumes the run there (``--root_path`` /
``--root`` / ``--name`` naming OUT_DIR), ``--transfer`` reads it and
``lighthand_tpu_torch.cli.eval`` evaluates it.

Run it where ``jax``, ``flax``, ``optax`` and ``orbax-checkpoint`` are
installed; the port's machine needs none of them, since what it writes is
``torch.save`` of tensors. This is the one file that imports the JAX
package and the port together.

What is carried across:

- the architecture from ``last_checkpoint.json``'s model record (or
  ``--model``); the checkpoint's parameter tree must be that model's, or
  the conversion raises;
- params and ``batch_stats`` through ``utils/weights.py``
  (``hrnet_from_flax`` / ``resnet_from_flax``: layout transposes, the
  deconv kernels' flip);
- Adam's ``mu`` and ``nu`` through the same mapping, into torch Adam's
  ``exp_avg`` / ``exp_avg_sq``; optax's ``count`` becomes each parameter's
  ``step``, the injected learning rate the param group's ``lr`` (optax's
  betas and eps are torch's defaults);
- ``epoch``, ``best_loss``, the early-stop ``count`` and the train
  ``step``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy  # noqa: E402
from lighthand_tpu.models import get_model as jax_get_model  # noqa: E402
from lighthand_tpu.train import create_train_state as jax_state  # noqa: E402
from lighthand_tpu.train.checkpoint import (  # noqa: E402
    resume_checkpoint as jax_resume,
)
from lighthand_tpu_torch.models import get_model  # noqa: E402
from lighthand_tpu_torch.models.hrnet import PoseHRNet  # noqa: E402
from lighthand_tpu_torch.train import create_train_state  # noqa: E402
from lighthand_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from lighthand_tpu_torch.utils.weights import (  # noqa: E402
    hrnet_from_flax,
    resnet_from_flax,
)


def _model_info(run_dir: str, model: str | None) -> dict:
    try:
        with open(os.path.join(run_dir, "last_checkpoint.json")) as f:
            info = json.load(f).get("model") or {}
    except (OSError, ValueError):
        info = {}
    if model:
        info = {**info, "name": model}
    if not info.get("name"):
        raise ValueError(f"{run_dir}/last_checkpoint.json records no model; "
                         "name it with --model")
    return {"name": info["name"], "precision": info.get("precision", "bf16")}


def _shapes(tree, prefix=()) -> dict:
    """{path: shape} of a params / batch_stats tree or its orbax metadata."""
    out = {}
    for k in tree.keys():
        v = tree[k]
        if hasattr(v, "keys"):
            out.update(_shapes(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = tuple(v.shape)
    return out


def _check_architecture(ckpt: str, template, name: str) -> None:
    saved = ocp.PyTreeCheckpointer().metadata(ckpt)
    saved = getattr(saved, "item_metadata", saved)
    for part in ("params", "batch_stats"):
        want = _shapes(getattr(template, part))
        got = _shapes(saved[part]) if part in saved.keys() else {}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:4]
            raise ValueError(
                f"{ckpt} does not hold a {name!r} model: its {part} differ "
                f"from the template's, e.g. {diff}")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _to_port(model, variables: Mapping) -> dict:
    if isinstance(model, PoseHRNet):
        return hrnet_from_flax(variables, model.cfg)
    return resnet_from_flax(variables, _resnet_layers(model))


def _resnet_layers(model) -> int:
    from lighthand_tpu_torch.models.resnet import RESNET_SPEC

    counts = tuple(len(getattr(model, f"layer{i}")) for i in range(1, 5))
    expansion = model.layer1[0].expansion
    for depth, (block, layers) in RESNET_SPEC.items():
        if tuple(layers) == counts and block.expansion == expansion:
            return depth
    raise ValueError(f"no ResNet depth has blocks {counts}")


def convert(run_dir: str, out_dir: str, ment: str = "good",
            model: str | None = None) -> str:
    """Write ``out_dir/checkpoint-{ment}/state.pt`` and
    ``out_dir/last_checkpoint.json`` from the JAX run in ``run_dir``;
    returns the checkpoint directory."""
    info = _model_info(run_dir, model)
    ckpt = os.path.abspath(os.path.join(run_dir, f"checkpoint-{ment}"))
    if not os.path.isdir(ckpt):
        raise FileNotFoundError(f"no orbax checkpoint at {ckpt}")
    template = jax_state(
        jax_get_model(info["name"], policy=JaxPolicy.full_precision()),
        jax.random.PRNGKey(0), input_shape=(1, 64, 64, 3))
    _check_architecture(ckpt, template, info["name"])
    best_loss, start_epoch, jstate, count = jax_resume(template, run_dir,
                                                       ment=ment)

    variables = _np({"params": jstate.params,
                     "batch_stats": jstate.batch_stats})
    adam = jstate.opt_state.inner_state[0]
    mu, nu = _np(adam.mu), _np(adam.nu)
    lr = float(jstate.opt_state.hyperparams["learning_rate"])

    state = create_train_state(get_model(info["name"]), lr=lr, device="cpu")
    model_sd = _to_port(state.model, variables)
    state.model.load_state_dict(model_sd)
    # Adam's moments take the params' path, BN stats borrowed to complete
    # the mapping and dropped
    moments = [_to_port(state.model, {"params": m,
                                      "batch_stats": variables["batch_stats"]})
               for m in (mu, nu)]
    optim = state.optimizer.state_dict()
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    names = [name for name, _ in state.model.named_parameters()]
    optim["state"] = {i: {"step": step.clone(),
                          "exp_avg": moments[0][name].clone(),
                          "exp_avg_sq": moments[1][name].clone()}
                      for i, name in enumerate(names)}
    state.optimizer.load_state_dict(optim)
    state.step = int(np.asarray(jstate.step))
    return save_checkpoint(state, out_dir, start_epoch - 1, best_loss, count,
                           ment=ment, model_info=info)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", help="the JAX run directory")
    parser.add_argument("out_dir", help="the port's run directory to write")
    parser.add_argument("--ment", default="good",
                        help="checkpoint-{ment} to convert (default good)")
    parser.add_argument("--model", default=None,
                        help="the architecture, where last_checkpoint.json "
                             "records none (e.g. simplebaseline, hrnet_w32)")
    a = parser.parse_args(argv)
    path = convert(a.run_dir, a.out_dir, a.ment, a.model)
    print(f"wrote {os.path.join(path, 'state.pt')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
