"""Mesh renderer: counterpart of ``lighthand_tpu/utils/mesh_render.py``.

The reference's opendr renderer (src/utils/renderer.py:512-690,
``Renderer.render`` / ``render_vertex_color``) as the JAX package rebuilt
it: a pinhole ``ProjectPoints`` camera (Rodrigues rotation, translation,
focal length, centre), three Lambertian point lights over a per-vertex
albedo, a z-buffered perspective-correct rasterizer and composition over a
background. The JAX package runs it on the host in numpy; the port runs it
on f64 tensors on the card unless the caller passes ``device="cpu"``, and
rasterizes with a CUDA kernel there (``ops/kernels/rasterize.py``, one
launch a render; the plain twin on the CPU).

The arithmetic is numpy's, in numpy's order: products of small matrices
are ``torch.matmul`` (on the CPU the same fused multiply-adds as numpy's),
cross products and sums of three are written out one operation at a time,
the cosines and sines of the host's scalar angles come from ``math`` (as
numpy's do), and the area-weighted vertex normals add each vertex's face
normals in numpy's order (``np.add.at`` over the first, second, then third
corner of each face) with one addition a contribution, padded with zeros,
never with atomics: on the CPU every function equals numpy bit for bit,
and the rasterizer's edge pixels do not move with the device's order.
Images are [H, W, 3] f64 tensors in [0, 1], like opendr's ``.r``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.ops.kernels.rasterize import rasterize_mesh_cuda

__all__ = [
    "rotate_y",
    "rodrigues_np",
    "project_points",
    "vertex_normals",
    "lambertian_point_light",
    "rasterize_mesh",
    "Renderer",
]


def _f64(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _faces(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, device=device).long()


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def rotate_y(points, angle: float, device=None) -> torch.Tensor:
    """Points [..., 3] rotated about the Y axis, ``points @ ry``
    (reference renderer.py:21-26)."""
    device = resolve_device(device)
    c, s = math.cos(angle), math.sin(angle)
    ry = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                      dtype=torch.float64, device=device)
    return _f64(points, device) @ ry


def rodrigues_np(rvec, device=None) -> torch.Tensor:
    """Axis-angle vector [3] -> rotation matrix [3, 3] (the JAX package's
    host twin of ``ops/geometry.py:rodrigues``, in f64; opendr's
    ``ProjectPoints`` takes ``rt`` in this form)."""
    device = resolve_device(device)
    rvec = _f64(rvec, device).reshape(3)
    theta = float(torch.linalg.vector_norm(rvec))
    eye = torch.eye(3, dtype=torch.float64, device=device)
    if theta < 1e-12:
        return eye
    k = rvec / torch.tensor(theta, dtype=torch.float64, device=device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    kx = torch.stack([torch.stack([zero, -k[2], k[1]]),
                      torch.stack([k[2], zero, -k[0]]),
                      torch.stack([-k[1], k[0], zero])])
    return eye + math.sin(theta) * kx + (1.0 - math.cos(theta)) * (kx @ kx)


def project_points(verts, rt, t, f, c, device=None):
    """opendr ``ProjectPoints`` (zero distortion): camera-frame transform,
    then the pinhole projection. Returns ((V, 2) pixel xy, (V,) depth)."""
    device = resolve_device(device)
    r = rodrigues_np(rt, device)
    cam = _f64(verts, device) @ r.T + _f64(t, device)
    z = cam[:, 2]
    f = torch.broadcast_to(_f64(f, device), (2,))
    c = _f64(c, device).reshape(2)
    eps = torch.tensor(1e-9, dtype=torch.float64, device=device)
    xy = cam[:, :2] / torch.where(z.abs() < 1e-9, eps, z)[:, None] * f + c
    return xy, z


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """(x0 + x1) + x2 along the last axis of length 3."""
    return x[..., 0] + x[..., 1] + x[..., 2]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root. On the card that is
    ``torch.sqrt``; PyTorch's f64 ``sqrt`` on the CPU is not (a value in
    about a hundred comes out one ulp low), so there numpy's is taken."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """``np.linalg.norm(x, axis=1, keepdims=True)`` of [N, 3]."""
    return _sqrt(_sum3(x * x))[:, None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.cross`` of [N, 3] rows, one rounding an operation."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def _add_at_rows(n: int, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``out = zeros((n, 3)); np.add.at(out, index, values)``: each row's
    values added one at a time in the order they come, as numpy adds them.
    A stable sort by row puts each row's values in that order; they are
    padded with zeros to the largest count and summed column by column."""
    order = torch.sort(index, stable=True).indices
    rows = index[order]
    counts = torch.bincount(index, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows.numel(), device=index.device) - starts[rows]
    width = int(counts.max()) if rows.numel() else 0
    padded = values.new_zeros((n, width, values.shape[1]))
    padded[rows, slot] = values[order]
    out = values.new_zeros((n, values.shape[1]))
    for j in range(width):
        out = out + padded[:, j]
    return out


def vertex_normals(verts, faces, device=None) -> torch.Tensor:
    """Area-weighted per-vertex normals (opendr ``VertNormals``: the face
    cross products accumulated unnormalized, then normalized)."""
    device = resolve_device(device)
    verts = _f64(verts, device)
    faces = _faces(faces, device)
    fn = _cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = _add_at_rows(verts.shape[0], faces.T.reshape(-1), fn.repeat(3, 1))
    norm = _norm3(vn)
    return vn / torch.where(norm < 1e-12, torch.ones_like(norm), norm)


def lambertian_point_light(verts, faces, light_pos, albedo, light_color,
                           normals=None, device=None) -> torch.Tensor:
    """Per-vertex diffuse term of one point light (opendr
    ``LambertianPointLight``): albedo * light_color * max(n . l, 0)."""
    device = resolve_device(device)
    verts = _f64(verts, device)
    if normals is None:
        normals = vertex_normals(verts, faces, device)
    d = _f64(light_pos, device).reshape(1, 3) - verts
    d = d / torch.clamp_min(_norm3(d), 1e-12)
    ndotl = torch.clamp_min(_sum3(_f64(normals, device) * d), 0.0)[:, None]
    albedo = torch.broadcast_to(_f64(albedo, device), verts.shape)
    return albedo * _f64(light_color, device) * ndotl


def rasterize_mesh(verts_px, verts_z, faces, vert_colors, background,
                   near: float = 1.0, far: float = float("inf"),
                   device=None) -> torch.Tensor:
    """Z-buffered, perspective-correct triangle rasterization: the colour
    of the nearest face at each pixel centre (the first of equals), its
    vertex colours interpolated with perspective-correct barycentrics, over
    ``background``; clipped to [0, 1]. On the card the rasterizer kernel,
    on the CPU its plain twin (``ops/kernels/rasterize.py``)."""
    device = resolve_device(device)
    return rasterize_mesh_cuda(_f64(verts_px, device), _f64(verts_z, device),
                               _faces(faces, device),
                               _f64(vert_colors, device),
                               _f64(background, device), near, far)


class Renderer:
    """The reference ``Renderer`` (src/utils/renderer.py:512-607) as the
    JAX package has it: the same constructor, colour table, default camera
    centre, ``far = |t_z - mean(v_z)| + 20`` frustum, near plane 1, three
    point lights (positions, colours, 120-degree yaw) and background
    composition (``use_bg`` pastes the input image under the mesh;
    otherwise a constant ``bg_color`` fill). ``device`` is where it
    renders (the card unless ``"cpu"``); images come back as f64 tensors
    there."""

    def __init__(self, width=800, height=600, near=0.5, far=1000,
                 faces=None, device=None):
        self.colors = {
            "hand": [0.9, 0.9, 0.9],
            "pink": [0.9, 0.7, 0.7],
            "light_blue": [0.65098039, 0.74117647, 0.85882353],
        }
        self.width = width
        self.height = height
        self.faces = faces
        self.device = resolve_device(device)

    def _shade(self, vertices, faces, albedo):
        dev = self.device
        yrot = math.radians(120)
        normals = vertex_normals(vertices, faces, dev)
        vc = lambertian_point_light(
            vertices, faces, rotate_y([-200.0, -100.0, -100.0], yrot, dev),
            albedo, [1.0, 1.0, 1.0], normals, dev)
        vc = vc + lambertian_point_light(
            vertices, faces, rotate_y([800.0, 10.0, 300.0], yrot, dev),
            albedo, [1.0, 1.0, 1.0], normals, dev)
        vc = vc + lambertian_point_light(
            vertices, faces, rotate_y([-500.0, 500.0, 1000.0], yrot, dev),
            albedo, [0.7, 0.7, 0.7], normals, dev)
        return vc

    def _render_common(self, vertices, faces, img, camera_t, camera_rot,
                       camera_center, use_bg, bg_color, albedo,
                       focal_length):
        dev = self.device
        if img is not None:
            height, width = img.shape[:2]
        else:
            height, width = self.height, self.width
        if faces is None:
            faces = self.faces
        if camera_center is None:
            camera_center = [width * 0.5, height * 0.5]
        # the far plane is host arithmetic on the caller's arrays, as numpy
        # does it (a sequential mean, in the vertices' own dtype)
        dist = abs(float(_host(camera_t).reshape(3)[2])
                   - float(np.mean(_host(vertices), axis=0)[2]))
        far = dist + 20.0
        vertices = _f64(vertices, dev)
        verts_px, verts_z = project_points(
            vertices, camera_rot, camera_t,
            focal_length * np.ones(2), camera_center, dev)

        if img is not None:
            img = _f64(img, dev)
            bg = (img if use_bg
                  else torch.ones_like(img) * _f64(bg_color, dev))
        else:
            bg = torch.ones((height, width, 3), dtype=torch.float64,
                            device=dev)
        vc = self._shade(vertices, faces, albedo)
        return rasterize_mesh(verts_px, verts_z, faces, vc, bg, near=1.0,
                              far=far, device=dev)

    def render(self, vertices, faces=None, img=None,
               camera_t=np.zeros(3), camera_rot=np.zeros(3),
               camera_center=None, use_bg=False, bg_color=(0.0, 0.0, 0.0),
               body_color=None, focal_length=5000, **kwargs):
        color = self.colors["light_blue" if body_color is None
                            else body_color]
        return self._render_common(vertices, faces, img, camera_t,
                                   camera_rot, camera_center, use_bg,
                                   bg_color, color, focal_length)

    def render_vertex_color(self, vertices, faces=None, img=None,
                            camera_t=np.zeros(3), camera_rot=np.zeros(3),
                            camera_center=None, use_bg=False,
                            bg_color=(0.0, 0.0, 0.0), vertex_color=None,
                            focal_length=5000, **kwargs):
        if vertex_color is None:
            vertex_color = self.colors["light_blue"]
        return self._render_common(vertices, faces, img, camera_t,
                                   camera_rot, camera_center, use_bg,
                                   bg_color, vertex_color, focal_length)
