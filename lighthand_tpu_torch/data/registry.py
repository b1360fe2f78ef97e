"""Dataset dispatch keyed by the --name routing string.

Counterpart of ``lighthand_tpu/data/registry.py`` (reference
``build_dataset``, src/tools/dataset.py:32-100), with the same routes,
cache tokens, fingerprint paths, lengths and seeds:

  frei      -> FreiHAND TSV (--train_yaml), 90/10 random split
  ours      -> LightHand train + LightHand eval (val_set)
  rhd       -> RHD training/evaluation splits
  interhand -> InterHand2.6M train/val
  gan       -> GANeratedHands, 90/10 random split
  mix       -> ours + frei + rhd, each routed on its own
               (``--ratio_of_other`` scales the non-LightHand part)
  stb       -> unsupported (the reference's STB class is a non-functional
               stub, dataset_loader.py:422-459)
  --eval    -> the Armo real wrist-camera set for both loaders

``--synthetic``, or a missing dataset tree, routes to generated data.
Decoded crops are cached beside each tree (``data/cache.py``) unless
``--no-cache-crops``.
"""

from __future__ import annotations

import os
from typing import Tuple

from lighthand_tpu_torch.config import Config
from lighthand_tpu_torch.data.cache import maybe_cache
from lighthand_tpu_torch.data.records import (
    ConcatSource,
    Source,
    SubsetSource,
    random_split_90_10,
)
from lighthand_tpu_torch.data.synthetic import SyntheticHands

def _synthetic_pair(cfg: Config) -> Tuple[Source, Source]:
    size = cfg.data.image_size
    # --num_our caps the train length, like the LightHand dataset
    n_train = max(cfg.data.batch_size, min(2048, cfg.data.num_our))
    train = SyntheticHands(length=n_train, size=size,
                           aug_ratio=cfg.data.ratio_of_aug)
    val = SyntheticHands(length=max(cfg.data.batch_size, n_train // 8),
                         size=size, seed=777)
    return train, val


def build_dataset(cfg: Config, name: str = None) -> Tuple[Source, Source]:
    """``name`` overrides ``cfg.data.dataset`` for one dispatch (the mix
    route's sub-sources)."""
    root = cfg.data.dataset_root
    size = cfg.data.image_size
    if cfg.eval.eval:
        if cfg.data.synthetic or not os.path.isdir(
                os.path.join(root, "Armo_hand_dataset")):
            test = SyntheticHands(length=971, size=size, seed=555,
                                  with_visibility=True)
            return test, test
        from lighthand_tpu_torch.data.armo import ArmoEvalSet

        test = ArmoEvalSet(root, phase="eval", image_size=size)
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
    cache = cfg.data.cache_crops

    if name == "ours":
        annos = os.path.join(root, "LightHand", "annotations")
        if not os.path.isdir(os.path.join(root, "LightHand")):
            return _synthetic_pair(cfg)
        from lighthand_tpu_torch.data.lighthand import (
            LightHandDataset,
            LightHandValSet,
        )

        train = LightHandDataset(root, "train", num_our=cfg.data.num_our,
                                 ratio_of_aug=cfg.data.ratio_of_aug,
                                 image_size=size)
        val = LightHandValSet(root, "eval", image_size=size)
        train = maybe_cache(
            train, root,
            f"ours-train|{size}|{cfg.data.num_our}|{cfg.data.ratio_of_aug}",
            enabled=cache,
            fingerprint_paths=[
                os.path.join(annos, "train", "CISLAB_train_data.json"),
                os.path.join(annos, "train2", "CISLAB_train2_data.json"),
            ])
        val = maybe_cache(
            val, root, f"ours-eval|{size}", enabled=cache,
            fingerprint_paths=[
                os.path.join(annos, "eval", "CISLAB_eval_data.json")])
        return train, val

    if name == "frei":
        if not os.path.isfile(cfg.data.train_yaml):
            return _synthetic_pair(cfg)
        from lighthand_tpu_torch.data.freihand import FreiHandTSVDataset

        full = FreiHandTSVDataset(cfg.data.train_yaml, is_train=True,
                                  image_size=size)
        # wrapped BEFORE the split, so cache rows live in full-dataset
        # index space and both subsets share one memmap
        fp = [cfg.data.train_yaml]
        if hasattr(full.img_tsv, "tsv_path"):
            fp.append(full.img_tsv.tsv_path)
        full = maybe_cache(
            full, os.path.dirname(cfg.data.train_yaml) or ".",
            f"frei-train|{size}|{full.seed}", enabled=cache,
            fingerprint_paths=fp)
        return random_split_90_10(full, seed=cfg.data.shuffle_seed)

    if name == "rhd":
        if not os.path.isdir(os.path.join(root, "RHD_published_v2")):
            return _synthetic_pair(cfg)
        from lighthand_tpu_torch.data.rhd import RHDDataset

        return tuple(
            maybe_cache(RHDDataset(root, ph, size), root,
                        f"rhd-{ph}|{size}", enabled=cache,
                        fingerprint_paths=[os.path.join(
                            root, "RHD_published_v2", ph,
                            f"anno_{ph}.pickle")])
            for ph in ("training", "evaluation"))

    if name == "interhand":
        if not os.path.isdir(os.path.join(root,
                                          "InterHand2.6M_5fps_batch1")):
            return _synthetic_pair(cfg)
        from lighthand_tpu_torch.data.interhand import InterHandDataset

        return (InterHandDataset(root, "train", size),
                InterHandDataset(root, "val", size))

    if name == "gan":
        if not os.path.isdir(os.path.join(root, "GANeratedHands_Release")):
            return _synthetic_pair(cfg)
        from lighthand_tpu_torch.data.gan import GANeratedDataset

        full = GANeratedDataset(root, size)
        return random_split_90_10(full, seed=cfg.data.shuffle_seed)

    if name == "stb":
        raise NotImplementedError(
            "STB is a non-functional stub in the reference "
            "(dataset_loader.py:422-459: __getitem__ is print()); "
            "not supported here either.")
    raise ValueError(f"unknown dataset {name!r}")
