"""Affine crop geometry on the host (numpy): a copy of the transform algebra
of ``lighthand_tpu/ops/affine.py`` (reference src/utils/image_ops.py:59-131),
which the FreiHAND reader uses for its crop and its keypoints. The JAX
module also holds the on-device warps (``hflip_px``, ``rotate_px_batch``),
which are not ported yet (ROADMAP.md, Queue 1: affine ops).
"""

from __future__ import annotations

import numpy as np


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """3x3 matrix mapping original-image pixels -> res-space pixels: the
    crop box side is 200*scale pixels centered at ``center``; optional
    rotation about the output center (the reference negates rot)."""
    center = np.asarray(center, dtype=np.float64)
    h = 200.0 * float(scale)
    t = np.zeros((3, 3), dtype=np.float64)
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rr = -np.deg2rad(rot)
        sn, cs = np.sin(rr), np.cos(rr)
        rot_mat = np.zeros((3, 3), dtype=np.float64)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1.0
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert: int = 0, rot: float = 0.0):
    """One pixel location, reference-exact including the 1-based offsets
    and int truncation (image_ops.py:85-95)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    new_pt = t @ new_pt
    return new_pt[:2].astype(int) + 1


def transform_points_batch(pts: np.ndarray, center, scale, res,
                           rot=0.0) -> np.ndarray:
    """Vectorized ``transform_point`` over [N, 2] points (forward only)."""
    t = get_transform(center, scale, res, rot=rot)
    homo = np.concatenate(
        [pts[:, :2] - 1.0, np.ones((pts.shape[0], 1))], axis=1
    )
    out = homo @ t.T
    return out[:, :2].astype(int) + 1


def crop_transform_matrix(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """Matrix mapping OUTPUT pixel coords -> INPUT pixel coords (for an
    inverse warp): the inverse of ``get_transform``."""
    return np.linalg.inv(get_transform(center, scale, res, rot=rot))


def rotation_about_center(h: float, w: float, degrees: float,
                          translate=(0.0, 0.0)) -> np.ndarray:
    """Output->input matrix for rotation about the image center followed by
    translation (the LightHand generator's ``i_rotate``,
    src/tools/dataset.py:326-337), as one inverse warp."""
    cx, cy = int(w / 2), int(h / 2)
    rad = np.deg2rad(degrees)
    cs, sn = np.cos(rad), np.sin(rad)
    # forward: p_out = R(p_in - c) + c + t  (cv2 rotates CCW for +deg)
    fwd = np.array(
        [[cs, sn, (1 - cs) * cx - sn * cy + translate[0]],
         [-sn, cs, sn * cx + (1 - cs) * cy + translate[1]],
         [0, 0, 1]],
        dtype=np.float64,
    )
    return np.linalg.inv(fwd)
