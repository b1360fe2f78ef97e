"""RHD (Rendered Handpose Dataset) source.

Counterpart of ``lighthand_tpu/data/rhd.py`` (reference ``RHD``,
src/utils/dataset_loader.py:288-420): pickle annotations; K-matrix
perspective projection; the left-hand joints (rows 21:42); samples whose
segmentation-mask hand extent is missing or under 30 px are dropped at load
(masks read as gray through the port's codec); a 0.4-margin crop around the
joint extent, clipped to the image; the joint reorder to the
wrist-first/thumb-first layout.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from lighthand_tpu_torch.data.imageio import imread_gray, imread_rgb
from lighthand_tpu_torch.data.lighthand import resize_to
from lighthand_tpu_torch.data.records import Sample, Source

RHD_JOINT_ORDER = [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13,
                   20, 19, 18, 17]


class RHDDataset(Source):
    def __init__(self, dataset_root: str, phase: str = "training",
                 image_size: int = 256, filter_small: bool = True):
        self.path = os.path.join(dataset_root, "RHD_published_v2")
        self.phase = phase
        self.image_size = image_size
        anno_path = os.path.join(self.path, phase, f"anno_{phase}.pickle")
        with open(anno_path, "rb") as f:
            raw = pickle.load(f)
        self.anno = []
        for idx in raw.keys():
            if filter_small and self._mask_too_small(idx):
                continue
            self.anno.append((idx, raw[idx]))

    def _mask_too_small(self, idx) -> bool:
        """dataset_loader.py:300-318: drop when the mask pixels > 17 span
        under 30 px (or the mask is missing)."""
        mask_path = os.path.join(self.path, self.phase, "mask",
                                 f"{idx:05d}.png")
        if not os.path.isfile(mask_path):
            return True
        ys, xs = np.where(imread_gray(mask_path) > 17)
        if len(xs) == 0:
            return True
        return (xs.max() - xs.min()) < 30 or (ys.max() - ys.min()) < 30

    def __len__(self):
        return len(self.anno)

    def __getitem__(self, i: int) -> Sample:
        idx, rec = self.anno[i]
        img = imread_rgb(os.path.join(self.path, self.phase, "color",
                                      f"{idx:05d}.png"))
        proj = (rec["K"] @ rec["xyz"].T).T
        joint = proj / proj[:, -1:].reshape(-1, 1)
        joint = joint[21:]

        h_min, w_min = joint[:, 1].min(), joint[:, 0].min()
        h_max, w_max = joint[:, 1].max(), joint[:, 0].max()
        spare = int(max(w_max - w_min, h_max - h_min) * 0.4)
        s_h_min = max(int(h_min - spare), 0)
        s_h_max = min(int(h_max + spare), img.shape[0])
        s_w_min = max(int(w_min - spare), 0)
        s_w_max = min(int(w_max + spare), img.shape[1])
        crop = img[s_h_min:s_h_max, s_w_min:s_w_max]

        joint = joint.copy()
        joint[:, 1] = (joint[:, 1] - s_h_min) / max(s_h_max - s_h_min, 1)
        joint[:, 0] = (joint[:, 0] - s_w_min) / max(s_w_max - s_w_min, 1)
        joint = joint[RHD_JOINT_ORDER, :2] * self.image_size

        return Sample(image=resize_to(crop, self.image_size),
                      joints=joint.astype(np.float32))
