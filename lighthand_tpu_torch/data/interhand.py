"""InterHand2.6M source (right-hand single-hand subset).

Counterpart of ``lighthand_tpu/data/interhand.py`` (reference
``Dataset_interhand``, src/utils/dataset_loader.py:57-234): COCO-format
annotations; world -> camera -> pixel projection on the host at load;
right hands only; a bbox-padded ~square 224-context crop; the joint
reorder to the wrist-first layout; joints scaled to the output size.
"""

from __future__ import annotations

import json
import os.path as op

import numpy as np

from lighthand_tpu_torch.data.imageio import imread_rgb
from lighthand_tpu_torch.data.lighthand import resize_to
from lighthand_tpu_torch.data.records import Sample, Source

INTERHAND_TO_OURS = (20, 3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13,
                     12, 19, 18, 17, 16)


def process_bbox(bbox, aspect_ratio: float = 1.0, expand: float = 1.25):
    """Aspect-ratio-preserving bbox expansion (reference
    src/utils/preprocessing.py:125-142): grow the short side to the aspect
    ratio, then scale both sides by 1.25 about the center; not clipped."""
    x, y, w, h = [float(v) for v in bbox]
    c_x, c_y = x + w / 2.0, y + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    w, h = w * expand, h * expand
    return np.array([c_x - w / 2.0, c_y - h / 2.0, w, h], np.float32)


def _context_crop(img, bbox, context: int = 224):
    """Crop with symmetric context padding toward a ``context``-px square,
    with the reference's int truncations and edge clamps
    (dataset_loader.py:203-223). Returns the crop plus the (int bbox,
    space_l, space_r) the joint transform needs."""
    h_img, w_img = img.shape[:2]
    b = [int(v) for v in bbox]
    if b[1] < 0:
        b[1] = 0
    if b[0] < 0:
        b[0] = 0
    space_l = int(context - b[3]) / 2.0
    space_r = int(context - b[2]) / 2.0
    if b[1] - space_l < 0:
        space_l = b[1]
    if b[1] + b[3] + space_l > h_img:
        space_l = h_img - (b[1] + b[3]) - 1
    if b[0] - space_r < 0:
        space_r = b[0]
    if b[0] + b[2] + space_r > w_img:
        space_r = w_img - (b[0] + b[2]) - 1
    crop = img[int(b[1] - space_l):int(b[1] + b[3] + space_l),
               int(b[0] - space_r):int(b[0] + b[2] + space_r)]
    return crop, b, space_l, space_r


class InterHandDataset(Source):
    def __init__(self, dataset_root: str, mode: str = "train",
                 image_size: int = 256):
        self.image_size = image_size
        root = op.join(dataset_root, "InterHand2.6M_5fps_batch1")
        self.img_path = op.join(root, "images")
        annot = op.join(root, "annotations", mode)
        self.mode = mode

        with open(op.join(annot, f"InterHand2.6M_{mode}_data.json")) as f:
            db = json.load(f)
        with open(op.join(annot, f"InterHand2.6M_{mode}_camera.json")) as f:
            cameras = json.load(f)
        with open(op.join(annot, f"InterHand2.6M_{mode}_joint_3d.json")) as f:
            joints3d = json.load(f)

        images = {im["id"]: im for im in db["images"]}
        self.datalist = []
        for ann in db["annotations"]:
            if ann.get("hand_type") != "right":
                continue
            img = images[ann["image_id"]]
            cap, cam, frame = (str(img["capture"]), str(img["camera"]),
                               str(img["frame_idx"]))
            campos = np.asarray(cameras[cap]["campos"][cam], np.float32)
            camrot = np.asarray(cameras[cap]["camrot"][cam], np.float32)
            focal = np.asarray(cameras[cap]["focal"][cam], np.float32)
            princpt = np.asarray(cameras[cap]["princpt"][cam], np.float32)
            world = np.asarray(joints3d[cap][frame]["world_coord"],
                               np.float32)
            cam_xyz = (camrot @ (world - campos[None]).T).T
            px = cam_xyz[:, :2] / np.maximum(cam_xyz[:, 2:3], 1e-6) \
                * focal[None] + princpt[None]
            bbox = process_bbox(np.asarray(ann["bbox"], np.float32))
            self.datalist.append({
                "img_file": op.join(self.img_path, mode, img["file_name"]),
                "joint_px": px,
                "bbox": bbox,
            })

    def __len__(self):
        return len(self.datalist)

    def __getitem__(self, idx: int) -> Sample:
        # the reference scales joints by ori/(side+2*space) and then by
        # image_size/ori; the ori factors cancel
        rec = self.datalist[idx]
        img = imread_rgb(rec["img_file"])
        crop, b, space_l, space_r = _context_crop(img, rec["bbox"])
        joints = rec["joint_px"].copy()
        joints[:, 0] = (joints[:, 0] - b[0] + space_r) \
            * (self.image_size / (b[2] + 2.0 * space_r))
        joints[:, 1] = (joints[:, 1] - b[1] + space_l) \
            * (self.image_size / (b[3] + 2.0 * space_l))
        joints = joints[list(INTERHAND_TO_OURS), :2]
        return Sample(image=resize_to(crop, self.image_size),
                      joints=joints.astype(np.float32))
