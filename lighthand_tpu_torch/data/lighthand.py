"""LightHand99K ("ours") dataset: CISLAB JSON annotations + JPEG crops.

Counterpart of ``lighthand_tpu/data/lighthand.py`` (reference
``CustomDataset`` / ``val_set``, src/tools/dataset.py:103-231), decoding and
resizing through the port's codec (``data/imageio.py``) instead of cv2.
The source only decodes + resizes to uint8; jitter, normalisation and the
targets run on the device (K1, K2).

Reference quirks kept:
- the length is min(num_our, len(meta)) (the reference returned num_our);
- the {phase}2 shard is read when num_our > 150000 (dataset.py:115-120);
- stored joints are in 224-px space and are scaled by image_size / 224;
- color jitter applies to the fixed PREFIX of the dataset
  (``aug_enabled = idx < len(meta) * ratio_of_aug``, dataset.py:134).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from lighthand_tpu_torch.data.imageio import imread_rgb, resize_linear
from lighthand_tpu_torch.data.records import Sample, Source


def read_resized(path: str, size: int) -> np.ndarray:
    """RGB image of ``path`` at ``size`` x ``size`` (unchanged when it is
    that size already)."""
    return resize_to(imread_rgb(path), size)


def resize_to(img: np.ndarray, size: int) -> np.ndarray:
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return resize_linear(img, size)


class LightHandDataset(Source):
    """phase in {train, val, eval}; reads
    {root}/LightHand/annotations/{phase}/CISLAB_{phase}_data.json, plus the
    {phase}2 shard when num_our > 150000."""

    def __init__(self, dataset_root: str, phase: str, *,
                 num_our: int = 300000, ratio_of_aug: float = 0.6,
                 image_size: int = 256):
        self.path = os.path.join(dataset_root, "LightHand")
        self.phase = phase
        self.image_size = image_size
        self.ratio_of_aug = ratio_of_aug

        anno = os.path.join(self.path, "annotations", phase,
                            f"CISLAB_{phase}_data.json")
        with open(anno, "rb") as f:
            self.meta: List[dict] = json.load(f)
        if num_our > 150000 and phase == "train":
            anno2 = os.path.join(self.path, "annotations", f"{phase}2",
                                 f"CISLAB_{phase}2_data.json")
            if os.path.isfile(anno2):
                with open(anno2, "rb") as f:
                    self.meta = self.meta + json.load(f)
        self._length = min(num_our, len(self.meta)) if phase == "train" \
            else len(self.meta)

    def __len__(self):
        return self._length

    def __getitem__(self, idx: int) -> Sample:
        rec = self.meta[idx]
        image = read_resized(rec["file_name"], self.image_size)
        joints = np.asarray(rec["joint_2d"], np.float32) * (
            self.image_size / 224.0
        )
        return Sample(
            image=image,
            joints=joints,
            aug_enabled=idx < len(self.meta) * self.ratio_of_aug,
        )


class LightHandValSet(LightHandDataset):
    """val_set: same storage, jitter off (dataset.py:215-231)."""

    def __init__(self, dataset_root: str, phase: str = "eval",
                 image_size: int = 256):
        super().__init__(dataset_root, phase, num_our=10**9,
                         ratio_of_aug=0.0, image_size=image_size)
