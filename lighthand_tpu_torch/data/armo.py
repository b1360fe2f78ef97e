"""Armo real wrist-camera eval set with occlusion categories.

Counterpart of ``lighthand_tpu/data/armo.py`` (reference ``eval_set``,
src/tools/dataset.py:233-300): records with fewer than 21 coordinates or
visibility flags are dropped at load; in the eval phase each item carries
its pose category and joints with visibility; the train/val phases build
max-combine targets (dataset.py:296-298). Joints are stored normalized and
scaled to the image size at read time (dataset.py:290-293).
"""

from __future__ import annotations

import json
import os

import numpy as np

from lighthand_tpu_torch.data.lighthand import read_resized
from lighthand_tpu_torch.data.records import Sample, Source

POSE_CATEGORIES = (
    "Standard",
    "Occlusion_by_Pinky",
    "Occlusion_by_Thumb",
    "Occlusion_by_Both",
)


class ArmoEvalSet(Source):
    def __init__(self, dataset_root: str, phase: str = "eval",
                 image_size: int = 256):
        self.image_path = os.path.join(dataset_root, "Armo_hand_dataset",
                                       "rgb")
        anno_path = os.path.join(dataset_root, "Armo_hand_dataset",
                                 "annotations.json")
        with open(anno_path, "r") as f:
            data = json.load(f)
        self.records = {
            k: v
            for k, v in data.items()
            if len(v["coordinates"]) >= 21 and len(v["visible"]) >= 21
        }
        self.keys = list(self.records)
        self.phase = phase
        self.image_size = image_size
        if phase != "eval":
            self.heatmap_style = "max"

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int) -> Sample:
        key = self.keys[idx]
        rec = self.records[key]
        joints = np.asarray(rec["coordinates"], np.float32)[:, :2]
        visible = np.asarray(rec["visible"], np.float32).reshape(21, 1)
        joints = joints * self.image_size
        image = read_resized(
            os.path.join(self.image_path, f"{rec['image_id']}.jpg"),
            self.image_size)
        if self.phase == "eval":
            joints_v = np.concatenate([joints, visible], axis=1)
            return Sample(image=image, joints=joints_v,
                          meta={"pose_ctgy": rec["pose_ctgy"], "idx": key})
        return Sample(image=image, joints=joints, hm_max=True)
