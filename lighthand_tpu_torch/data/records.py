"""Common record protocol for all dataset sources: a copy of
``lighthand_tpu/data/records.py`` (numpy only).

A source is index-addressable and returns fixed-shape host arrays:
  image:  uint8 [S, S, 3] RGB (S = cfg.data.image_size, default 256)
  joints: float32 [21, 2] (train/val) or [21, 3] with visibility (Armo eval)
  meta:   optional dict (e.g. pose category for the Armo set)

Augmentation that the reference did on the host per-sample (color jitter,
normalization, heatmap rasterization) happens LATER, on device, in the
preprocess/train step — sources only decode + geometric-crop +
resize, which keeps host work minimal and shapes static (SURVEY.md
section 7 hard-part 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class Sample:
    image: np.ndarray                   # uint8 [S, S, 3]
    joints: np.ndarray                  # float32 [21, 2] or [21, 3]
    aug_enabled: bool = False           # per-sample color-jitter gate
    noise_enabled: bool = False         # per-sample frei channel-noise gate
    hm_max: bool = False                # max-combine heatmap target
    meta: Optional[Dict[str, Any]] = None


class Source:
    """Minimal Dataset interface (torch-free).

    ``heatmap_style`` routes the on-device target rasterizer: "msra"
    (generate_target, reference src/tools/dataset.py:165-212) or "max"
    (GenerateHeatmap max-combine, frei_dataloader.py:17-46 — GAN and the
    Armo train/val phases).
    """

    heatmap_style = "msra"

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Sample:
        raise NotImplementedError

    def getitems(self, indices) -> list:
        """Batch fetch; sources backed by seekable storage override this
        with a bulk read (data/freihand.py uses the native TSV engine)."""
        return [self[int(i)] for i in indices]


class SubsetSource(Source):
    def __init__(self, base: Source, indices):
        self.base = base
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.base[self.indices[idx]]

    def getitems(self, indices) -> list:
        # forward the mapped indices so the base's bulk path (native TSV
        # reads, decoded-crop cache) stays active through a split
        return self.base.getitems([self.indices[int(i)] for i in indices])


class ConcatSource(Source):
    def __init__(self, *sources: Source):
        self.sources = sources
        self._offsets = np.cumsum([0] + [len(s) for s in sources])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        k = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.sources[k][idx - int(self._offsets[k])]


def source_heatmap_styles(source: Source) -> set:
    """Set of target styles a source (tree) emits — used by the trainer to
    pick a static rasterizer when uniform and per-sample select otherwise."""
    if isinstance(source, SubsetSource):
        return source_heatmap_styles(source.base)
    if isinstance(source, ConcatSource):
        out: set = set()
        for s in source.sources:
            out |= source_heatmap_styles(s)
        return out
    return {getattr(source, "heatmap_style", "msra")}


def random_split_90_10(source: Source, seed: int = 9001):
    """The reference's frei/gan 90/10 random_split (src/tools/dataset.py:77)."""
    n = len(source)
    n_train = int(n * 0.9)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return (SubsetSource(source, perm[:n_train]),
            SubsetSource(source, perm[n_train:]))
