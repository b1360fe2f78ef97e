"""GANeratedHands source.

Counterpart of ``lighthand_tpu/data/gan.py`` (reference ``GAN``,
src/utils/dataset_loader.py:462-511): walks the ``noObject`` folders pairing
``*_color.png`` with ``*_joint2D.txt`` (comma floats -> 21x2, truncated to
int). The reference builds max-combine targets (``GenerateHeatmap(64,
21)(joint/4)``, dataset_loader.py:509): every Sample sets ``hm_max`` and
the source's ``heatmap_style`` is "max" (train/step.py:make_targets).
"""

from __future__ import annotations

import os

import numpy as np

from lighthand_tpu_torch.data.lighthand import read_resized
from lighthand_tpu_torch.data.records import Sample, Source


class GANeratedDataset(Source):
    heatmap_style = "max"

    def __init__(self, dataset_root: str, image_size: int = 256):
        self.img_path = os.path.join(dataset_root, "GANeratedHands_Release",
                                     "data", "noObject")
        self.image_size = image_size
        self.meta = []
        for folder in sorted(os.listdir(self.img_path)):
            fdir = os.path.join(self.img_path, folder)
            if not os.path.isdir(fdir):
                continue
            for name in sorted(os.listdir(fdir)):
                if name.endswith(".png"):
                    num = name.split("_")[0]
                    self.meta.append(
                        (os.path.join(folder, name),
                         os.path.join(folder, f"{num}_joint2D.txt"))
                    )

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx: int) -> Sample:
        img_rel, anno_rel = self.meta[idx]
        with open(os.path.join(self.img_path, anno_rel)) as f:
            vals = [float(v) for v in f.read().strip().rstrip(",").split(",")]
        joints = np.asarray(vals, np.float32).astype(int).reshape(21, -1)
        image = read_resized(os.path.join(self.img_path, img_rel),
                             self.image_size)
        return Sample(image=image, joints=joints.astype(np.float32),
                      hm_max=True)
