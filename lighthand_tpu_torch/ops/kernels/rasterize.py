"""The mesh renderer's z-buffered rasterizer as a CUDA kernel
(``csrc/rasterize.cu``), with its plain twin.

Replaces no Pallas kernel: the JAX package rasterizes on the host, one face
at a time in numpy (``lighthand_tpu/utils/mesh_render.py:119-193``,
``rasterize_mesh``). The kernel's note says what bounds it on the card and
what its design does about it.

Both compute what the sequential loop computes. At each pixel the loop
keeps the first face, in index order, whose perspective-correct depth is
strictly below the z-buffer's and below ``far``: so the colour comes from
the smallest depth, and from the smallest face index among equal depths.
Every quantity is f64, in numpy's order of operations, each operation
rounded once (the kernel is built with ``--fmad=false``; every division of
the twin divides by a tensor, which PyTorch does not turn into a reciprocal
multiply), so the kernel equals the twin bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lighthand_tpu_torch.ops.kernels._build import library
from lighthand_tpu_torch.ops.kernels.int8_conv import _sm_count


def _face_setup(verts_px, verts_z, faces, h: int, w: int, near, far):
    """Per face: the corner positions [F, 3, 2] and depths [F, 3], the
    clipped box (x0, x1, y0, y1) [F, 4] and whether the face is drawn at
    all (the whole-triangle near cull, the far cull, an empty box, a
    degenerate triangle), computed for all faces at once with the loop's
    operations."""
    p = verts_px[faces]
    z = verts_z[faces]
    keep = ~((z <= near).any(1) | (z >= far).all(1))
    x0 = torch.clamp_min(torch.floor(p[:, :, 0].amin(1)), 0)
    x1 = torch.clamp_max(torch.ceil(p[:, :, 0].amax(1)) + 1, w)
    y0 = torch.clamp_min(torch.floor(p[:, :, 1].amin(1)), 0)
    y1 = torch.clamp_max(torch.ceil(p[:, :, 1].amax(1)) + 1, h)
    keep &= (x0 < x1) & (y0 < y1)
    denom = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    keep &= ~(denom.abs() < 1e-12)
    box = torch.stack([x0, x1, y0, y1], 1)
    return p, z, denom, box, keep


def rasterize_mesh_plain(verts_px: torch.Tensor, verts_z: torch.Tensor,
                         faces: torch.Tensor, vert_colors: torch.Tensor,
                         background: torch.Tensor, near: float = 1.0,
                         far: float = float("inf")) -> torch.Tensor:
    """The plain twin: the JAX package's per-face loop in torch, on the
    tensors' device. ``verts_px`` [V, 2] and ``verts_z`` [V] f64,
    ``faces`` [F, 3] int, ``vert_colors`` [V, 3] f64, ``background``
    [H, W, 3] f64 -> the image [H, W, 3] f64, clipped to [0, 1]."""
    h, w = background.shape[:2]
    color = background.clone()
    zbuf = torch.full((h, w), float("inf"), dtype=torch.float64,
                      device=background.device)
    faces = faces.long()
    p, z, denom, box, keep = _face_setup(verts_px, verts_z, faces, h, w,
                                         near, far)
    far_t = torch.tensor(far, dtype=torch.float64, device=color.device)
    for f in torch.nonzero(keep).flatten().tolist():
        x0, x1, y0, y1 = (int(v) for v in box[f].tolist())
        pf, zf, tri = p[f], z[f], faces[f]
        xs, ys = torch.meshgrid(
            torch.arange(x0, x1, dtype=torch.float64, device=color.device)
            + 0.5,
            torch.arange(y0, y1, dtype=torch.float64, device=color.device)
            + 0.5, indexing="xy")
        w1 = ((xs - pf[0, 0]) * (pf[2, 1] - pf[0, 1])
              - (pf[2, 0] - pf[0, 0]) * (ys - pf[0, 1])) / denom[f]
        w2 = ((pf[1, 0] - pf[0, 0]) * (ys - pf[0, 1])
              - (xs - pf[0, 0]) * (pf[1, 1] - pf[0, 1])) / denom[f]
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        inv_z = w0 / zf[0] + w1 / zf[1] + w2 / zf[2]
        clamped = torch.clamp_min(inv_z, 1e-12)
        pix_z = torch.ones_like(clamped) / clamped
        patch_z = zbuf[y0:y1, x0:x1]
        win = inside & (pix_z < patch_z) & (pix_z < far_t)
        attr = (w0[..., None] * vert_colors[tri[0]] / zf[0]
                + w1[..., None] * vert_colors[tri[1]] / zf[1]
                + w2[..., None] * vert_colors[tri[2]] / zf[2]
                ) * pix_z[..., None]
        patch_c = color[y0:y1, x0:x1]
        patch_c[win] = attr[win]
        patch_z[win] = pix_z[win]
    return torch.clamp(color, 0.0, 1.0)


# The kernel's geometry, (tile, threads a pixel, list capacity): a block a
# screen tile of (width, height) pixels, each pixel's threads walking
# every n-th face of the tile's list, a list in shared memory of at least a
# block's thread count (a pass of faces always fits an empty list). An
# image of at least PIXELS_PER_SM pixels an SM takes LARGE: small tiles, a
# thread a pixel. A smaller one takes SMALL, which spreads the crowded
# tiles (the mesh's poles) over more threads and the card; each is the
# faster of the two on its side of the rule for a hand mesh at 800x600 and
# 224x224 (kernel_breakdown.py times both). tests/test_torch_mesh_render.py
# replays the block's walk in numpy with them.
LARGE = ((8, 8), 1, 64)
SMALL = ((4, 4), 4, 64)
PIXELS_PER_SM = 1024
# the card's scratch: a face's box (4 int32) and record (10 f64), and a
# box for each group of 32 faces
FACE_BYTES, GROUP_BYTES = 96, 16


def choose_geometry(h: int, w: int, sms: int) -> tuple:
    """The kernel's geometry for an h x w image on a card of ``sms`` SMs."""
    return LARGE if h * w >= PIXELS_PER_SM * sms else SMALL


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("rasterize")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lh_rasterize.argtypes = [p, p, p, p, p, i, i, i, d, d, p, p, i, i,
                                 i, i, p]
    lib.lh_rasterize.restype = ctypes.c_int
    return lib


def _check(verts_px, verts_z, faces, vert_colors, background) -> None:
    v = verts_z.shape[0] if verts_z.ndim == 1 else -1
    if (verts_px.shape != (v, 2) or vert_colors.shape != (v, 3)
            or faces.ndim != 2 or faces.shape[1] != 3
            or background.ndim != 3 or background.shape[2] != 3):
        raise ValueError(
            "expected verts_px [V, 2], verts_z [V], faces [F, 3], "
            "vert_colors [V, 3], background [H, W, 3]; got "
            f"{tuple(verts_px.shape)}, {tuple(verts_z.shape)}, "
            f"{tuple(faces.shape)}, {tuple(vert_colors.shape)}, "
            f"{tuple(background.shape)}")
    for name, t in (("verts_px", verts_px), ("verts_z", verts_z),
                    ("vert_colors", vert_colors),
                    ("background", background)):
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
    if faces.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"faces must be int32 or int64, got {faces.dtype}")
    devices = {t.device for t in (verts_px, verts_z, faces, vert_colors,
                                  background)}
    if len(devices) != 1:
        raise ValueError(f"the tensors lie on several devices: {devices}")


def rasterize_mesh_cuda(verts_px: torch.Tensor, verts_z: torch.Tensor,
                        faces: torch.Tensor, vert_colors: torch.Tensor,
                        background: torch.Tensor, near: float = 1.0,
                        far: float = float("inf"),
                        geometry: tuple = None) -> torch.Tensor:
    """The z-buffered, perspective-correct rasterization of
    ``rasterize_mesh_plain``. On CUDA tensors this launches the kernel (or
    raises), with ``geometry`` (tile, threads a pixel, list capacity), by
    default ``choose_geometry`` of the image; on CPU tensors it computes the
    plain twin.
    ``rasterize_mesh_cuda.launches`` counts the kernel launches (one call,
    one count, for its setup and tile kernels). The card's scratch is
    ``FACE_BYTES`` a face and ``GROUP_BYTES`` a group of 32; nothing a
    pixel but the image."""
    _check(verts_px, verts_z, faces, vert_colors, background)
    if background.device.type == "cpu":
        return rasterize_mesh_plain(verts_px, verts_z, faces, vert_colors,
                                    background, near, far)
    if background.device.type != "cuda":
        raise ValueError(f"unsupported device {background.device}")
    h, w = background.shape[:2]
    n_faces, n_verts = faces.shape[0], verts_z.shape[0]
    if h * w >= 2**31 or n_faces >= 2**31:
        raise ValueError(f"{h}x{w} pixels or {n_faces} faces exceed the "
                         "kernel's 32-bit indices")
    if n_faces and (int(faces.min()) < 0 or int(faces.max()) >= n_verts):
        raise ValueError(f"a face indexes outside the {n_verts} vertices")
    dev = background.device
    verts_px, verts_z = verts_px.contiguous(), verts_z.contiguous()
    vert_colors = vert_colors.contiguous()
    background = background.contiguous()
    faces32 = faces.to(torch.int32).contiguous()
    out = torch.empty_like(background)
    scratch = torch.empty(max(n_faces * FACE_BYTES
                              + -(-n_faces // 32) * GROUP_BYTES, 1),
                          dtype=torch.uint8, device=dev)
    tile, sub, cap = geometry or choose_geometry(h, w, _sm_count(dev.index))
    with torch.cuda.device(dev):
        err = _lib().lh_rasterize(
            verts_px.data_ptr(), verts_z.data_ptr(), faces32.data_ptr(),
            vert_colors.data_ptr(), background.data_ptr(), n_faces, h, w,
            float(near), float(far), out.data_ptr(), scratch.data_ptr(),
            *tile, sub, cap, torch.cuda.current_stream().cuda_stream)
        rasterize_mesh_cuda.launches += 1
    if err:
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error {err}")
    return out


rasterize_mesh_cuda.launches = 0
