"""Skeleton renderers: counterpart of ``lighthand_tpu/utils/vis3d.py``.

The reference's InterHand visualizers (src/utils/vis.py:20-124:
``get_keypoint_rgb``, ``vis_keypoints``, ``vis_3d_keypoints``) with
per-finger colour grading, as the JAX package has them.

- ``vis_keypoints`` draws the JAX package's cv2 pixels in numpy on the host
  (``utils/visualize.py``: ``draw_line`` with its thickness, filled
  circles) and writes ``.jpg`` / ``.jpeg`` through ``data/imageio.py:
  imwrite_rgb`` (cv2's bytes at quality 95) and ``.png`` through
  ``encode_png_rgb`` (a PNG that decodes to cv2's pixels). Where cv2 would
  pick another encoder by the extension, the port raises ``ValueError``.
- ``vis_3d_keypoints`` returns a Matplotlib figure and imports matplotlib
  only when called, as the JAX package does.
- ``draw_text`` is not ported: the JAX function strokes ``cv2.putText``'s
  font, which cv2 5.0 draws from an outline font built into its binary and
  cv2 4.13 from Hershey strokes, and neither font's data is in the
  repository. It raises ``NotImplementedError`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from lighthand_tpu_torch.data.imageio import encode_png_rgb, imwrite_rgb
from lighthand_tpu_torch.utils.visualize import draw_line, fill_circle

__all__ = [
    "hand_skeleton_21",
    "get_keypoint_rgb",
    "vis_keypoints",
    "vis_3d_keypoints",
    "draw_text",
]

_FINGERS = ("thumb", "index", "middle", "ring", "pinky")


def hand_skeleton_21() -> list[dict]:
    """The 21-joint LightHand hand as an InterHand-style skeleton list
    (`[{'name', 'parent_id'}, ...]`), wrist + 4 joints per finger in the
    order utils/visualize.py:PARENTS encodes. Names are chosen so the
    reference suffix->color table applies unchanged (vis.py:20-70:
    saturation grades from `<finger>0` at the knuckle to `<finger>3` at
    the tip)."""
    skeleton = [{"name": "wrist", "parent_id": -1}]
    for f_idx, finger in enumerate(_FINGERS):
        base = 1 + 4 * f_idx
        for k in range(4):
            skeleton.append({
                "name": f"{finger}{k}",
                "parent_id": base + k - 1 if k else 0,
            })
    return skeleton


def get_keypoint_rgb(skeleton: Sequence[dict]) -> dict:
    """Suffix-matched finger color grading (vis.py:20-70): red thumb,
    green index, orange middle, blue ring, magenta pinky, lightening
    toward the fingertip; anything unmatched (wrist/root) is olive."""
    # ramp[k] colors `<finger>{k}`, ramp[4] colors `<finger>_null`
    # (vis.py:25-67; the reference table has no `<finger>0` row outside
    # the thumb — ramp[0] extends the grading one step lighter there).
    ramps = {
        "thumb": [(255, 204, 204), (255, 153, 153), (255, 102, 102),
                  (255, 51, 51), (255, 0, 0)],
        "index": [(204, 255, 204), (153, 255, 153), (102, 255, 102),
                  (51, 255, 51), (0, 255, 0)],
        "middle": [(255, 229, 204), (255, 204, 153), (255, 178, 102),
                   (255, 153, 51), (255, 128, 0)],
        "ring": [(204, 229, 255), (153, 204, 255), (102, 178, 255),
                 (51, 153, 255), (0, 128, 255)],
        "pinky": [(255, 204, 255), (255, 153, 255), (255, 102, 255),
                  (255, 51, 255), (255, 0, 255)],
    }
    rgb = {}
    for joint in skeleton:
        name = joint["name"]
        color = (230, 230, 0)
        for finger, ramp in ramps.items():
            if name.endswith(f"{finger}_null"):
                color = ramp[4]
            else:
                for k in range(4):
                    if name.endswith(f"{finger}{k}"):
                        color = ramp[k]
                        break
                else:
                    continue
            break
        rgb[name] = color
    return rgb


def vis_keypoints(
    img: np.ndarray,
    kps: np.ndarray,
    score: np.ndarray,
    skeleton: Sequence[dict],
    filename: Optional[str] = None,
    score_thr: float = 0.4,
    line_width: int = 3,
    circle_rad: int = 3,
    save_path: Optional[str] = None,
) -> np.ndarray:
    """Bone+joint overlay with per-score gating (vis.py:73-97): a bone is
    drawn in the parent joint's color only when both endpoint scores
    clear `score_thr`; each cleared joint gets a filled circle. `img` is
    HWC or CHW uint8-ish RGB; returns the annotated HWC uint8 array and
    writes it when a destination is given (``.jpg``, ``.jpeg`` or ``.png``;
    another extension raises ``ValueError``)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[2] not in (1, 3):
        img = img.transpose(1, 2, 0)  # reference passes CHW (vis.py:76)
    canvas = np.ascontiguousarray(img.astype(np.uint8).copy())
    if canvas.shape[2] == 1:
        canvas = np.repeat(canvas, 3, axis=2)
    kps = np.asarray(kps, dtype=np.float64)
    score = np.asarray(score, dtype=np.float64).reshape(-1)
    rgb = get_keypoint_rgb(skeleton)

    for i, joint in enumerate(skeleton):
        pid = joint["parent_id"]
        xy = (int(round(kps[i, 0])), int(round(kps[i, 1])))
        if pid != -1 and score[i] > score_thr and score[pid] > score_thr:
            pxy = (int(round(kps[pid, 0])), int(round(kps[pid, 1])))
            draw_line(canvas, xy, pxy, rgb[skeleton[pid]["name"]],
                      line_width)
        if score[i] > score_thr:
            fill_circle(canvas, xy, circle_rad, rgb[joint["name"]])

    if filename is not None:
        out = (os.path.join(save_path, filename) if save_path
               else filename)
        ext = os.path.splitext(out)[1].lower()
        if ext not in (".jpg", ".jpeg", ".png"):
            raise ValueError(f"{out}: the port writes .jpg, .jpeg and .png, "
                             f"not {ext or 'a file without an extension'}")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        if ext == ".png":
            with open(out, "wb") as f:
                f.write(encode_png_rgb(canvas))
        else:
            imwrite_rgb(out, canvas)
    return canvas


def vis_3d_keypoints(
    kps_3d: np.ndarray,
    score: np.ndarray,
    skeleton: Sequence[dict],
    filename: Optional[str] = None,
    score_thr: float = 0.4,
    line_width: int = 3,
    circle_rad: int = 3,
):
    """3D skeleton plot in the reference's (x, z, -y) axis convention
    (vis.py:100-124), rendered headlessly. Returns the Matplotlib
    figure; saves when `filename` is given."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    kps_3d = np.asarray(kps_3d, dtype=np.float64)
    score = np.asarray(score, dtype=np.float64).reshape(-1)
    rgb = get_keypoint_rgb(skeleton)

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    for i, joint in enumerate(skeleton):
        pid = joint["parent_id"]
        pcolor = np.array(rgb[skeleton[pid]["name"]]) / 255.0
        if pid != -1 and score[i] > score_thr and score[pid] > score_thr:
            ax.plot(kps_3d[[i, pid], 0], kps_3d[[i, pid], 2],
                    -kps_3d[[i, pid], 1], c=pcolor, linewidth=line_width)
        if score[i] > score_thr:
            ax.scatter(kps_3d[i, 0], kps_3d[i, 2], -kps_3d[i, 1],
                       c=(np.array(rgb[joint["name"]]) / 255.0)[None],
                       marker="o")
        if pid != -1 and score[pid] > score_thr:
            ax.scatter(kps_3d[pid, 0], kps_3d[pid, 2], -kps_3d[pid, 1],
                       c=pcolor[None], marker="o")
    if filename is not None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fig.savefig(filename, dpi=fig.dpi)
    return fig


def draw_text(input_image: np.ndarray, content: dict) -> np.ndarray:
    """Not ported: the JAX function's captions are ``cv2.putText`` of
    ``FONT_HERSHEY_SIMPLEX``, whose glyphs cv2 5.0 and cv2 4.13 draw from
    different fonts (see the module docstring). Raises
    ``NotImplementedError``."""
    raise NotImplementedError(
        "draw_text is not ported: cv2.putText's font differs between cv2 "
        "5.0 and 4.13 and neither font's data is in the repository "
        "(ROADMAP Queue 1)")
