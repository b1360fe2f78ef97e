"""Camera / geometric transforms: counterpart of ``lighthand_tpu/ops/geometry.py``.

Reference: src/utils/transforms.py:11-59 (cam2pixel/pixel2cam/world2cam) and
src/utils/geometric_layers.py:10-94 (rodrigues/quat2mat/orthographic
projection/camera calibration). Torch functions in f32 on the device of
their first tensor argument, differentiable, in the JAX package's order of
operations.
"""

from __future__ import annotations

import torch


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def cam2pixel(cam_coord, f, c) -> torch.Tensor:
    """[N,3] camera coords -> [N,3] (u, v, z). f=(fx,fy), c=(cx,cy)."""
    cam_coord = _f32(cam_coord)
    f, c = _f32(f, cam_coord.device), _f32(c, cam_coord.device)
    x = cam_coord[:, 0] / (cam_coord[:, 2] + 1e-8) * f[0] + c[0]
    y = cam_coord[:, 1] / (cam_coord[:, 2] + 1e-8) * f[1] + c[1]
    return torch.stack([x, y, cam_coord[:, 2]], dim=1)


def pixel2cam(pixel_coord, f, c) -> torch.Tensor:
    pixel_coord = _f32(pixel_coord)
    f, c = _f32(f, pixel_coord.device), _f32(c, pixel_coord.device)
    x = (pixel_coord[:, 0] - c[0]) / f[0] * pixel_coord[:, 2]
    y = (pixel_coord[:, 1] - c[1]) / f[1] * pixel_coord[:, 2]
    return torch.stack([x, y, pixel_coord[:, 2]], dim=1)


def world2cam(world_coord, r, t) -> torch.Tensor:
    """[3,N] world -> camera: R @ (p - t). Matches transforms.py:25-27."""
    world_coord = _f32(world_coord)
    r, t = _f32(r, world_coord.device), _f32(t, world_coord.device)
    return r @ (world_coord - t.reshape(3, 1))


def rodrigues(theta) -> torch.Tensor:
    """Axis-angle [B,3] -> rotation matrices [B,3,3] via quaternions
    (geometric_layers.py:10-27)."""
    theta = _f32(theta)
    shifted = theta + 1e-8
    angle = torch.sqrt((shifted * shifted).sum(dim=1))[:, None]
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=1)
    return quat2mat(quat)


def quat2mat(quat) -> torch.Tensor:
    """[B,4] (w,x,y,z) -> [B,3,3] (geometric_layers.py:29-46)."""
    quat = _f32(quat)
    norm = torch.sqrt((quat * quat).sum(dim=1, keepdim=True))
    q = quat / torch.clamp_min(norm, 1e-8)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w**2, x**2, y**2, z**2
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    mat = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    )
    return mat.reshape(quat.shape[0], 3, 3)


def orthographic_projection(x, camera) -> torch.Tensor:
    """[B,N,3] points + [B,3] (s, tx, ty) -> [B,N,2]
    (geometric_layers.py:48-60)."""
    camera = camera.reshape(-1, 1, 3)
    x_trans = x[:, :, :2] + camera[:, :, 1:]
    return camera[:, :, 0:1] * x_trans


def euler_to_rotation(angles_deg) -> torch.Tensor:
    """XYZ Euler angles (degrees) -> rotation matrix [3,3]."""
    rad = torch.deg2rad(_f32(angles_deg))
    cx, cy, cz = torch.cos(rad)
    sx, sy, sz = torch.sin(rad)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)

    def mat(*rows):
        return torch.stack([torch.stack(r) for r in rows])

    rx = mat((one, zero, zero), (zero, cx, -sx), (zero, sx, cx))
    ry = mat((cy, zero, sy), (zero, one, zero), (-sy, zero, cy))
    rz = mat((cz, -sz, zero), (sz, cz, zero), (zero, zero, one))
    return rz @ ry @ rx


def camera_calibration(points, euler_deg, translation, focal, principal,
                       out_size: float = 224.0) -> torch.Tensor:
    """Full extrinsic+intrinsic projection of [N,3] world points to pixels
    in an out_size^2 image (geometric_layers.py:62-94 semantics: Euler->R,
    p_cam = R (p - t), perspective divide, * focal + principal)."""
    p = _f32(points)
    dev = p.device
    r = euler_to_rotation(_f32(euler_deg, dev))
    t = _f32(translation, dev)
    cam = (r @ (p - t).T).T
    xy = cam[:, :2] / torch.clamp_min(cam[:, 2:3], 1e-8)
    return xy * _f32(focal, dev) + _f32(principal, dev)
