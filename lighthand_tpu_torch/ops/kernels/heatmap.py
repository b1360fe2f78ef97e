"""K2: MSRA heatmap targets as a CUDA kernel (``csrc/heatmap.cu``).

Replaces ``lighthand_tpu/ops/pallas/heatmap.py:generate_target_batch_pallas``.
The kernel's note says what bounds it on the card and what its design does
about it. Its plain twin is ``ops/heatmap.py:generate_target_batch``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lighthand_tpu_torch.ops.heatmap import (
    FEAT_STRIDE,
    HEATMAP_SIZE,
    SIGMA,
    generate_target_batch as generate_target_batch_plain,
)
from lighthand_tpu_torch.ops.kernels._build import library

MAX_BATCH = 65535  # gridDim.y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("heatmap")
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.lh_heatmap_targets.argtypes = [p, ll, ll, p, i, i, i, f, i, f, p]
    lib.lh_heatmap_targets.restype = ctypes.c_int
    return lib


def generate_target_batch_cuda(joints: torch.Tensor,
                               heatmap_size: int = HEATMAP_SIZE,
                               stride: float = FEAT_STRIDE,
                               sigma: float = SIGMA) -> torch.Tensor:
    """[B, J, 2+] float joints (pixels) -> f32 [B, J, H, H] targets.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it computes the plain twin. ``generate_target_batch_cuda.launches``
    counts the kernel launches. f32 joints with a unit last stride go to
    the kernel as they are; other joints are converted first."""
    if joints.ndim != 3 or joints.shape[-1] < 2:
        raise ValueError(f"joints must be [B, J, 2+], got {tuple(joints.shape)}")
    if not joints.is_floating_point():
        raise TypeError(f"joints must be floating point, got {joints.dtype}")
    if joints.device.type == "cpu":
        return generate_target_batch_plain(joints, heatmap_size, stride, sigma)
    if joints.device.type != "cuda":
        raise ValueError(f"unsupported device {joints.device}")

    b, j = joints.shape[:2]
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} exceeds the kernel's {MAX_BATCH}")
    if joints.dtype != torch.float32 or joints.stride(-1) != 1:
        joints = joints[..., :2].float().contiguous()
    out = torch.empty((b, j, heatmap_size, heatmap_size), dtype=torch.float32,
                      device=joints.device)
    tmp = int(3 * sigma)
    inv = 1.0 / (2.0 * sigma * sigma)
    with torch.cuda.device(joints.device):
        err = _lib().lh_heatmap_targets(
            joints.data_ptr(), joints.stride(0), joints.stride(1),
            out.data_ptr(), b, j, heatmap_size, stride, tmp, inv,
            torch.cuda.current_stream().cuda_stream)
        generate_target_batch_cuda.launches += 1
    if err:
        raise RuntimeError(f"heatmap kernel launch failed: CUDA error {err}")
    return out


generate_target_batch_cuda.launches = 0
