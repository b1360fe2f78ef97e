"""Affine geometry: counterpart of ``lighthand_tpu/ops/affine.py``.

- On the host (numpy): a copy of the transform algebra (reference
  src/utils/image_ops.py:59-131), which the FreiHAND reader uses for its
  crop and its keypoints.
- On the device (PyTorch, f32): the bilinear inverse warp, the per-sample
  rotation and horizontal flip of the train step's ``--rot-aug`` /
  ``--flip`` route, the image flip and the bilinear resize. They are
  XLA-generated ``jnp`` in the JAX package (no Pallas kernel), so they are
  plain PyTorch here, with the JAX formulas in the same order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


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


# --------------------------------------------------------------------------
# On-device warps
# --------------------------------------------------------------------------

def affine_warp(image: torch.Tensor, mat_out_to_in,
                out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear inverse warp of an HWC image, in f32.

    ``mat_out_to_in`` (3x3 or 2x3) takes output (x, y, 1) to input (x, y).
    Samples outside the image are zero (cv2's default borderValue=0,
    image_ops.py:43)."""
    return affine_warp_batch(image[None], torch.as_tensor(mat_out_to_in)[None],
                             out_hw)[0]


def affine_warp_batch(images: torch.Tensor, mats,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] x [B, 3, 3] -> [B, h, w, C] f32: per output pixel the
    JAX formulas in their order (x_in = m00 x + m01 y + m02, floor, the two
    weights, four taps clipped into the image and zeroed outside it, the
    rows blended first)."""
    b, h_in, w_in, c = images.shape
    h_out, w_out = out_hw
    dev = images.device
    m = torch.as_tensor(mats, dtype=torch.float32).to(dev)
    ys, xs = torch.meshgrid(torch.arange(h_out, dtype=torch.float32,
                                         device=dev),
                            torch.arange(w_out, dtype=torch.float32,
                                         device=dev), indexing="ij")

    def row(r):
        return (m[:, r, 0, None, None] * xs + m[:, r, 1, None, None] * ys
                + m[:, r, 2, None, None])

    x_in, y_in = row(0), row(1)  # [B, h, w]
    x0, y0 = torch.floor(x_in), torch.floor(y_in)
    wx, wy = (x_in - x0)[..., None], (y_in - y0)[..., None]
    flat = images.float().reshape(b, h_in * w_in, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w_in) & (yi >= 0) & (yi < h_in)
        xi_c = torch.clamp(xi, 0, w_in - 1).to(torch.int64)
        yi_c = torch.clamp(yi, 0, h_in - 1).to(torch.int64)
        idx = (yi_c * w_in + xi_c).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(b, h_out, w_out, c)
        return vals * valid[..., None].float()

    top = tap(y0, x0) * (1 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def resize_bilinear(image: torch.Tensor,
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an HWC image to f32 (torchvision Resize), as
    ``jax.image.resize(method="bilinear")``: half-pixel centres, and a
    triangle filter widened by the scale where it shrinks (antialiased)."""
    x = image.float().permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0)


# --------------------------------------------------------------------------
# Flip and rotation augmentation (the train step's --flip / --rot-aug). The
# reference's flip helpers (image_ops.py:173-200) are disabled
# (frei_dataloader.py:107) and permute SMPL body joints; a hand mirror keeps
# the joint order and reflects x.
# --------------------------------------------------------------------------

HAND_FLIP_PERM = list(range(21))


def flip_img(img: torch.Tensor) -> torch.Tensor:
    """Mirror an HWC image left to right."""
    return torch.flip(img, dims=(1,))


def rotate_px_batch(images: torch.Tensor, joints: torch.Tensor,
                    degrees: torch.Tensor):
    """Per-sample rotation by ``degrees`` [B] about the image centre
    ((W-1)/2, (H-1)/2): the NHWC batch is warped with the out->in matrix
    R(-theta) about the centre, the pixel joints rotate forward
    (p' = R (p - c) + c) and extra joint columns (visibility) pass
    through."""
    h, w = images.shape[1], images.shape[2]
    rad = torch.deg2rad(degrees.float())
    cs, sn = torch.cos(rad), torch.sin(rad)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0

    x = joints[..., 0] - cx
    y = joints[..., 1] - cy
    jx = cs[:, None] * x - sn[:, None] * y + cx
    jy = sn[:, None] * x + cs[:, None] * y + cy
    joints = torch.cat([jx[..., None], jy[..., None], joints[..., 2:]],
                       dim=-1)

    zeros, ones = torch.zeros_like(cs), torch.ones_like(cs)
    m = torch.stack([
        torch.stack([cs, sn, cx - cs * cx - sn * cy], dim=-1),
        torch.stack([-sn, cs, cy + sn * cx - cs * cy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=1)  # [B, 3, 3]
    return affine_warp_batch(images, m, (h, w)), joints


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """An int64 index vector on ``device``, made once (no host-to-device
    copy in a step that a CUDA graph captures)."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def hflip_px(images: torch.Tensor, joints: torch.Tensor,
             flip_mask: torch.Tensor):
    """Per-sample horizontal flip of an NHWC batch and its pixel joints:
    where ``flip_mask`` [B] is set, the image is mirrored and
    x -> (W - 1) - x under ``HAND_FLIP_PERM``; extra joint columns stay."""
    f = flip_mask.bool()
    images = torch.where(f[:, None, None, None], torch.flip(images, dims=(2,)),
                         images)
    width = images.shape[2]
    perm = _index(tuple(HAND_FLIP_PERM), joints.device)
    fx = (width - 1.0) - joints[:, perm, 0]
    x = torch.where(f[:, None], fx, joints[..., 0])
    return images, torch.cat([x[..., None], joints[..., 1:]], dim=-1)
