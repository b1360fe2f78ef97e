"""Prediction / GT overlays: counterpart of ``lighthand_tpu/utils/visualize.py``.

Reference: visualize_gt/visualize_pred (src/utils/visualize.py:10-64): 21
joints and 20 bones over the denormalized image, saved to
``{output_dir}/{train,val,eval}_image/{epoch}_epoch/iter_N.jpg``.

The JAX package draws with OpenCV; the port draws the same pixels in numpy,
on the host:

- a joint is ``cv2.circle(img, (x, y), 2, (255, 255, 255), -1)``: OpenCV's
  integer midpoint circle, filled with one horizontal span per row, each
  span cut to the image;
- a bone is ``cv2.line(img, p0, p1, color, 1)`` (8-connected): the line is
  first cut to the image by ``cv2.clipLine``'s arithmetic (the second end
  moved along the line through the first end's moved position, the cuts
  truncated toward zero), then walked from its left end by OpenCV's
  ``LineIterator``, which takes ``dx + 1`` steps along the major axis;
- joints are cast with ``int()`` (truncation toward zero).

``save_overlay`` writes the JPEG with the port's encoder
(``data/imageio.py:imwrite_rgb``, cv2's bytes at quality 95).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lighthand_tpu_torch.data.imageio import imwrite_rgb
from lighthand_tpu_torch.ops.color import denormalize_imagenet

# parents array (visualize.py:15)
PARENTS = np.array(
    [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
)

_FINGER_COLORS = [(255, 80, 80), (80, 255, 80), (80, 80, 255),
                  (255, 255, 80), (255, 80, 255)]


def _hline(img: np.ndarray, y: int, x0: int, x1: int, color) -> None:
    h, w = img.shape[:2]
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if 0 <= y < h and x0 <= x1:
        img[y, x0:x1 + 1] = color


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            _hline(img, y, cx - dx, cx + dx, color)
        for y in (cy - dx, cy + dx):
            _hline(img, y, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _cut(a: int, num: int, den: int) -> int:
    """``(int64)((double)a * num / den)``: truncation toward zero."""
    return int(float(a) * float(num) / float(den))


def clip_line(w: int, h: int, p1, p2):
    """``cv2.clipLine((0, 0, w, h), p1, p2)``: the ends moved into the
    image, or None where the line misses it."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _cut(a - y1, x2 - x1, y2 - y1)
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _cut(a - y2, x2 - x1, y2 - y1)
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _cut(a - x1, y2 - y1, x2 - x1)
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _cut(a - x2, y2 - y1, x2 - x1)
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """``cv2.line(img, p1, p2, color, 1)`` (LINE_8) in place."""
    h, w = img.shape[:2]
    clipped = clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:  # walked from the left end
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:  # a step along both axes
            err += 2 * dx - 2 * dy
            x += sx
            y += sy
        else:  # a step along the major axis
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += sx


def draw_joints(image_u8: np.ndarray, joints: np.ndarray) -> np.ndarray:
    """The skeleton over a copy of ``image_u8`` (uint8 [H, W, 3])."""
    img = np.ascontiguousarray(np.array(image_u8, copy=True))
    joints = np.asarray(joints)[:, :2]
    for j in range(21):
        x, y = int(joints[j, 0]), int(joints[j, 1])
        fill_circle(img, (x, y), 2, (255, 255, 255))
        p = PARENTS[j]
        if p >= 0:
            color = _FINGER_COLORS[(j - 1) // 4 % 5]
            px, py = int(joints[p, 0]), int(joints[p, 1])
            draw_line(img, (px, py), (x, y), color)
    return img


def save_overlay(
    normalized_image: np.ndarray,
    gt_joints: Optional[np.ndarray],
    pred_joints: Optional[np.ndarray],
    output_dir: str,
    phase: str,
    epoch: int,
    iteration: int,
) -> str:
    """Write the GT | prediction overlay of the ImageNet-normalized HWC float
    image (one panel where one of the two is None) to
    ``{output_dir}/{phase}_image/{epoch}_epoch/iter_{iteration}.jpg``;
    returns the path. The image is denormalized in f32, then
    ``clip(x * 255, 0, 255)`` and truncated, as the JAX package does."""
    img = denormalize_imagenet(torch.as_tensor(np.asarray(normalized_image)))
    img = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)
    panels = []
    if gt_joints is not None:
        panels.append(draw_joints(img, gt_joints))
    if pred_joints is not None:
        panels.append(draw_joints(img, pred_joints))
    canvas = np.concatenate(panels, axis=1) if len(panels) > 1 else panels[0]

    out_dir = os.path.join(output_dir, f"{phase}_image", f"{epoch}_epoch")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"iter_{iteration}.jpg")
    imwrite_rgb(path, canvas)
    return path
