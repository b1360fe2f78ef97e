"""FreiHAND dataset from TSV shards (the format the reference ships in).

Counterpart of ``lighthand_tpu/data/freihand.py`` (reference
``HandMeshTSVDataset``, src/datasets/frei_dataloader.py:49-448). A yaml
descriptor points at img / label / hw TSVs (+ optional linelist). Train
augmentation draws from ``default_rng(seed * 2_000_003 + idx)``:

- rotation N(0, 90) clipped to +-180, zeroed w.p. 0.6   (:121-129)
- scale N(1, 0.25) clipped to [0.75, 1.25]               (:126-127)
- per-channel pixel noise in [0.6, 1.4], on the device (K1's
  ``noise_enabled`` rows)                                (:118)

The crop is one inverse affine warp (``warp_affine_inverse``: the matrix
maps output pixels to input pixels, as cv2's ``WARP_INVERSE_MAP`` reads it)
at 224 px, then a resize to 256; the 2D keypoints go through the forward
transform, normalized to [-1, 1], and back to pixels as
(kp*100 + 112) * 256/224 (:335). RGB end to end, as in the JAX package.
"""

from __future__ import annotations

import json
import os.path as op

import numpy as np

from lighthand_tpu_torch.data.imageio import warp_affine_inverse
from lighthand_tpu_torch.data.lighthand import resize_to
from lighthand_tpu_torch.data.records import Sample, Source
from lighthand_tpu_torch.data.tsv import (
    CompositeTSVFile,
    TSVFile,
    find_file_path_in_yaml,
    img_from_base64,
    load_from_yaml_file,
)
from lighthand_tpu_torch.ops.affine import (
    crop_transform_matrix,
    get_transform,
)


class FreiHandTSVDataset(Source):
    def __init__(self, yaml_file: str, *, is_train: bool = True,
                 image_size: int = 256, seed: int = 9001):
        cfg = load_from_yaml_file(yaml_file)
        self.is_composite = cfg.get("composite", False)
        root = op.dirname(yaml_file)
        self.root = root
        if not self.is_composite:
            img_file = find_file_path_in_yaml(cfg["img"], root)
            label_file = find_file_path_in_yaml(cfg.get("label"), root)
            hw_file = find_file_path_in_yaml(cfg.get("hw"), root)
            linelist_file = find_file_path_in_yaml(cfg.get("linelist"), root)
            self.img_tsv = TSVFile(img_file)
            self.label_tsv = TSVFile(label_file) if label_file else None
            self.hw_tsv = TSVFile(hw_file) if hw_file else None
            self.line_list = None
            if linelist_file:
                with open(linelist_file) as f:
                    self.line_list = [int(x) for x in f if x.strip()]
        else:
            linelist_file = find_file_path_in_yaml(cfg.get("linelist"), root)
            self.img_tsv = CompositeTSVFile(cfg["img"], linelist_file,
                                            root=root)
            self.label_tsv = CompositeTSVFile(cfg["label"], linelist_file,
                                              root=root) if cfg.get("label") \
                else None
            self.hw_tsv = CompositeTSVFile(cfg["hw"], linelist_file,
                                           root=root)
            self.line_list = list(range(self.hw_tsv.num_rows()))

        self.is_train = is_train
        self.image_size = image_size
        self.crop_res = 224  # img_res (frei_dataloader.py:75)
        self.scale_factor = 0.25
        self.noise_factor = 0.4
        self.rot_factor = 90.0
        self.seed = seed

    def _line_no(self, idx: int) -> int:
        return idx if self.line_list is None else self.line_list[idx]

    def __len__(self) -> int:
        if self.line_list is not None:
            return len(self.line_list)
        return self.img_tsv.num_rows()

    def _augm_params(self, rng: np.random.Generator):
        """(rot_deg, scale) per frei_dataloader.py:105-132; flip always 0."""
        if not self.is_train:
            return 0.0, 1.0
        rot = float(np.clip(rng.standard_normal() * self.rot_factor,
                            -2 * self.rot_factor, 2 * self.rot_factor))
        sc = float(np.clip(rng.standard_normal() * self.scale_factor + 1.0,
                           1 - self.scale_factor, 1 + self.scale_factor))
        if rng.uniform() <= 0.6:
            rot = 0.0
        return rot, sc

    def getitems(self, indices) -> list:
        """Batch fetch: all image and label rows in one TSV engine call
        each, then per-item processing."""
        if self.is_composite:
            return [self[int(i)] for i in indices]
        line_nos = [self._line_no(int(i)) for i in indices]
        img_rows = self.img_tsv.read_rows(line_nos)
        label_rows = (self.label_tsv.read_rows(line_nos)
                      if self.label_tsv else [None] * len(line_nos))
        return [self._process(int(i), ir, lr)
                for i, ir, lr in zip(indices, img_rows, label_rows)]

    def __getitem__(self, idx: int) -> Sample:
        line_no = self._line_no(idx)
        return self._process(idx, self.img_tsv[line_no],
                             self.label_tsv[line_no]
                             if self.label_tsv else None)

    def _process(self, idx: int, img_row, label_row) -> Sample:
        img = img_from_base64(img_row[-1])

        anno = json.loads(label_row[1])[0]
        center = np.asarray(anno["center"], np.float64)
        scale = float(anno["scale"])
        joints_2d = np.asarray(anno["2d_joints"], np.float32)
        if joints_2d.ndim == 3:
            joints_2d = joints_2d[0]

        rng = np.random.default_rng(self.seed * 2_000_003 + idx)
        rot, sc = self._augm_params(rng)

        # one inverse warp: the matrix maps OUTPUT pixels to INPUT pixels
        # and is applied as such (cv2's WARP_INVERSE_MAP); applying it as a
        # forward map would warp the image by the opposite rotation and the
        # reciprocal scale of what the keypoints get
        res = (self.crop_res, self.crop_res)
        mat = crop_transform_matrix(center, sc * scale, res, rot=rot)
        crop = resize_to(warp_affine_inverse(img, mat[:2], res),
                         self.image_size)

        # keypoints through the forward transform (frei_dataloader.py:
        # 149-161): crop px (1-based, int-truncated) -> [-1, 1] ->
        # (kp*100+112)*(size/224) pixels (:335)
        t = get_transform(center, sc * scale, res, rot=rot)
        homo = np.concatenate(
            [joints_2d[:, :2] + 1.0 - 1.0,  # reference adds 1 then subs 1
             np.ones((joints_2d.shape[0], 1), np.float32)], axis=1)
        px = (homo @ t.T)[:, :2].astype(int) + 1
        kp_norm = 2.0 * px.astype(np.float32) / self.crop_res - 1.0
        joint_2d = (kp_norm * 100.0 + 112.0) * (self.image_size / 224.0)

        return Sample(image=crop.astype(np.uint8),
                      joints=joint_2d.astype(np.float32),
                      aug_enabled=False,
                      noise_enabled=self.is_train)
