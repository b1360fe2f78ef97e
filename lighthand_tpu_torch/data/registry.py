"""Dataset dispatch keyed by the --name routing string.

Counterpart of ``lighthand_tpu/data/registry.py`` (reference
``build_dataset``, src/tools/dataset.py:32-100), with the same routes,
lengths and seeds for generated data:

  ours, frei, rhd, interhand, gan -> generated data when ``--synthetic`` or
                                     when the dataset tree is missing
  mix  -> ours + frei + rhd, each routed on its own (``--ratio_of_other``
          scales the non-LightHand part)
  stb  -> unsupported (the reference's STB class is a non-functional stub,
          dataset_loader.py:422-459)
  --eval -> a generated stand-in for the Armo wrist-camera set, with
            visibility, for both loaders

The readers of the real trees are not ported yet (ROADMAP.md, Queue 1:
dataset sources). Where a tree is present the port raises: it never puts
generated data in place of a dataset it found.
"""

from __future__ import annotations

import os
from typing import Tuple

from lighthand_tpu_torch.config import Config
from lighthand_tpu_torch.data.records import (
    ConcatSource,
    Source,
    SubsetSource,
)
from lighthand_tpu_torch.data.synthetic import SyntheticHands

# where each route finds its tree (lighthand_tpu/data/registry.py)
_TREES = {"ours": "LightHand", "rhd": "RHD_published_v2",
          "interhand": "InterHand2.6M_5fps_batch1",
          "gan": "GANeratedHands_Release"}


def _synthetic_pair(cfg: Config) -> Tuple[Source, Source]:
    size = cfg.data.image_size
    # --num_our caps the train length, like the LightHand dataset
    n_train = max(cfg.data.batch_size, min(2048, cfg.data.num_our))
    train = SyntheticHands(length=n_train, size=size,
                           aug_ratio=cfg.data.ratio_of_aug)
    val = SyntheticHands(length=max(cfg.data.batch_size, n_train // 8),
                         size=size, seed=777)
    return train, val


def _tree_not_ported(path: str) -> NotImplementedError:
    return NotImplementedError(
        f"found the dataset tree {path!r}, but its reader is not ported yet "
        "(ROADMAP.md, Queue 1: dataset sources); pass --synthetic to train "
        "on generated data")


def build_dataset(cfg: Config, name: str = None) -> Tuple[Source, Source]:
    """``name`` overrides ``cfg.data.dataset`` for one dispatch (the mix
    route's sub-sources)."""
    root = cfg.data.dataset_root
    if cfg.eval.eval:
        armo = os.path.join(root, "Armo_hand_dataset")
        if not cfg.data.synthetic and os.path.isdir(armo):
            raise _tree_not_ported(armo)
        test = SyntheticHands(length=971, size=cfg.data.image_size,
                              seed=555, with_visibility=True)
        return test, test

    name = name or cfg.data.dataset
    if name == "mix":
        # handled before the synthetic shortcut so each sub-dataset routes
        # on its own
        trains, vals = [], []
        for sub in ("ours", "frei", "rhd"):
            t, v = build_dataset(cfg, name=sub)
            if sub != "ours" and 0 < cfg.data.ratio_of_other < 1:
                t = SubsetSource(t, range(int(len(t)
                                              * cfg.data.ratio_of_other)))
            trains.append(t)
            vals.append(v)
        return ConcatSource(*trains), ConcatSource(*vals)

    if cfg.data.synthetic:
        return _synthetic_pair(cfg)
    if name == "stb":
        raise NotImplementedError(
            "STB is a non-functional stub in the reference "
            "(dataset_loader.py:422-459: __getitem__ is print()); "
            "not supported here either.")
    if name == "frei":
        tree = cfg.data.train_yaml
        present = os.path.isfile(tree)
    elif name in _TREES:
        tree = os.path.join(root, _TREES[name])
        present = os.path.isdir(tree)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    if not present:
        return _synthetic_pair(cfg)
    raise _tree_not_ported(tree)
