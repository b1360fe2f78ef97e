"""K1: fused u8 -> augmented, normalised image + MSRA targets as a CUDA kernel
(``csrc/fused_aug.cu``).

Replaces ``lighthand_tpu/ops/pallas/fused_aug.py:fused_aug_targets_pallas``.
As there, the random draws happen outside the kernel in a tiny ``[B, 12]``
tensor (``draw_aug_params``) with the same packing:

    0: jitter enable, 1-4: brightness/contrast/saturation/hue factors,
    5-8: op index per order slot (clamped to [0, 3], as ``lax.switch``
         clamps it), 9-11: channel-noise factors (pre-gated)

and the kernel is a deterministic function of (u8 image, params, joints).
The kernel's note says what bounds it on the card and what its design does
about it. ``fused_aug_targets_plain`` is its plain twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lighthand_tpu_torch.ops.color import (
    channel_pixel_noise,
    color_jitter,
    divide,
    draw_jitter,
    normalize_imagenet,
)
from lighthand_tpu_torch.ops.heatmap import (
    FEAT_STRIDE,
    HEATMAP_SIZE,
    SIGMA,
    pack_centers,
    rasterize_centers,
)
from lighthand_tpu_torch.ops.kernels._build import library

NUM_PARAMS = 12
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# The kernel's constants (kPx, kMaxThreads, kMaxCluster in fused_aug.cu). A
# cluster above 8 blocks needs the non-portable attribute, which the kernel
# sets; K1 uses no dynamic shared memory.
PX_PER_THREAD = 8
MAX_THREADS = 1024
MAX_CLUSTER = 16
# Blocks of up to this many threads fit twice on an SM (64 registers a
# thread), so one image's loads and stores overlap another's arithmetic.
SHARED_SM_THREADS = 512
MAX_BATCH = 65535  # gridDim.y


MAX_PIXELS = 2**31 - 1  # the kernel indexes an image's pixels with an int


class Geometry(NamedTuple):
    """One cluster of ``cluster`` blocks of ``threads`` threads per image.
    With ``groups`` 1, thread t of block r holds pixels [8 (r threads + t),
    + 8) in registers; above that capacity it walks the 8-pixel groups
    r threads + t + i cluster threads, i < ``groups``."""
    cluster: int
    threads: int
    groups: int = 1


def launch_geometry(height: int, width: int) -> Geometry:
    """K1's launch for one ``height`` x ``width`` image: the smallest
    power-of-two cluster whose blocks of at most ``SHARED_SM_THREADS``
    threads hold every pixel, or, past 16 such blocks, 16 blocks of up to
    ``MAX_THREADS``; the threads are spread evenly over the blocks
    (256x256: 16 blocks of 512). An image above ``MAX_CLUSTER *
    MAX_THREADS * PX_PER_THREAD`` pixels takes 16 blocks whose threads walk
    the fewest groups of 8 pixels that cover it (384x384: 576 threads, 2
    groups each). Raises only above ``MAX_PIXELS``."""
    if height * width > MAX_PIXELS:
        raise ValueError(f"a {height}x{width} image exceeds the kernel's "
                         f"{MAX_PIXELS} pixels")
    n_groups = -(-(height * width) // PX_PER_THREAD)
    cluster = 1
    while cluster < MAX_CLUSTER and -(-n_groups // cluster) > SHARED_SM_THREADS:
        cluster *= 2
    per_block = -(-n_groups // cluster)
    threads = max(32, -(-per_block // 32) * 32)
    if threads <= MAX_THREADS:
        return Geometry(cluster, threads)
    groups = -(-per_block // MAX_THREADS)
    threads = -(-per_block // groups)
    return Geometry(cluster, -(-threads // 32) * 32, groups)


def draw_aug_params(generator: torch.Generator, aug_enabled: torch.Tensor,
                    noise_enabled: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample jitter/noise draws, packed [B, 12] f32 on the generator's
    device, in the ranges of ``fused_aug.py:171-185``: ``draw_jitter`` at its
    default ranges (brightness, contrast, saturation in [0.5, 1.5), hue in
    [-0.5, 0.5), a random permutation of the 4 ops), then noise in [0.6,
    1.4) gated to 1.0 where ``noise_enabled`` is 0 (absent == all 0)."""
    b = aug_enabled.shape[0]
    dev = generator.device
    factors, order = draw_jitter(generator, b)
    pn = 0.6 + 0.8 * torch.rand((b, 3), generator=generator, device=dev)
    aug = aug_enabled.to(dev, torch.float32)[:, None]
    if noise_enabled is not None:
        noise = noise_enabled.to(dev, torch.float32)[:, None]
        pn = pn * noise + (1.0 - noise)
    else:
        pn = torch.ones_like(pn)
    return torch.cat([aug, factors, order.float(), pn], dim=1)


def _check(images_u8: torch.Tensor, joints: torch.Tensor,
           params: torch.Tensor, out_dtype: torch.dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 \
            or images_u8.shape[-1] != 3:
        raise ValueError("images_u8 must be uint8 [B, H, W, 3], got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    b = images_u8.shape[0]
    if joints.ndim != 3 or joints.shape[0] != b or joints.shape[-1] < 2:
        raise ValueError(f"joints must be [B, J, 2+], got {tuple(joints.shape)}")
    if params.dtype != torch.float32 or tuple(params.shape) != (b, NUM_PARAMS):
        raise ValueError(f"params must be f32 [B, {NUM_PARAMS}], got "
                         f"{params.dtype} {tuple(params.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {_OUT_DTYPES}")
    devices = {images_u8.device, joints.device, params.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def fused_aug_targets_plain(images_u8: torch.Tensor, joints: torch.Tensor,
                            params: torch.Tensor,
                            heatmap_size: int = HEATMAP_SIZE,
                            stride: float = FEAT_STRIDE,
                            sigma: float = SIGMA,
                            out_dtype: torch.dtype = torch.bfloat16):
    """The kernel's function in plain PyTorch: (images [B, H, W, 3] in
    ``out_dtype``, targets f32 [B, J, hm, hm])."""
    _check(images_u8, joints, params, out_dtype)
    img = divide(images_u8.float(), 255.0)
    img = color_jitter(img, params[:, 1:5], params[:, 5:9].to(torch.int32),
                       enable=params[:, 0])
    img = channel_pixel_noise(img, params[:, 9:12])
    images = normalize_imagenet(img).to(out_dtype)
    packed = pack_centers(joints, heatmap_size, stride, sigma)
    return images, rasterize_centers(packed, heatmap_size, sigma)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("fused_aug")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.lh_fused_aug_targets.argtypes = [p, p, p, ll, ll, p, i, p, i, i, i, i,
                                         i, i, f, f, i, i, i, p]
    lib.lh_fused_aug_targets.restype = i
    lib.lh_count_div_mismatches.argtypes = [p, p]
    lib.lh_count_div_mismatches.restype = i
    return lib


def count_div_mismatches(device: torch.device) -> int:
    """How many of normalize's numerators (x - mean_c for every f32 x in
    [0, 1], each channel) get other bits from K1's reciprocal-and-correction
    division than from IEEE division, on the card. K1 relies on 0."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().lh_count_div_mismatches(
            bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"division check launch failed: CUDA error {err}")
    return int(bad.item())


def fused_aug_targets_cuda(images_u8: torch.Tensor, joints: torch.Tensor,
                           params: torch.Tensor,
                           heatmap_size: int = HEATMAP_SIZE,
                           stride: float = FEAT_STRIDE,
                           sigma: float = SIGMA,
                           out_dtype: torch.dtype = torch.bfloat16):
    """(images NHWC [B, H, W, 3] in ``out_dtype``, targets f32
    [B, J, hm, hm]) from a u8 NHWC batch, its joints in pixels and the
    packed draws of ``draw_aug_params``.

    On CUDA tensors this launches the kernel (or raises); on CPU tensors it
    computes the plain twin. ``fused_aug_targets_cuda.launches`` counts the
    kernel launches: one per call, and no other CUDA work besides the two
    output allocations (a copy only for joints that are not f32 with a
    unit last stride)."""
    _check(images_u8, joints, params, out_dtype)
    if images_u8.device.type == "cpu":
        return fused_aug_targets_plain(images_u8, joints, params,
                                       heatmap_size, stride, sigma,
                                       out_dtype)
    if images_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {images_u8.device}")

    b, h, w, _ = images_u8.shape
    if b > MAX_BATCH:
        raise ValueError(f"batch {b} exceeds the kernel's {MAX_BATCH}")
    geo = launch_geometry(h, w)
    images_u8 = images_u8.contiguous()
    params = params.contiguous()
    if joints.dtype != torch.float32 or joints.stride(-1) != 1:
        joints = joints[..., :2].float().contiguous()
    j = joints.shape[1]
    dev = images_u8.device
    out = torch.empty((b, h, w, 3), dtype=out_dtype, device=dev)
    targets = torch.empty((b, j, heatmap_size, heatmap_size),
                          dtype=torch.float32, device=dev)
    tmp = int(3 * sigma)
    inv = 1.0 / (2.0 * sigma * sigma)
    with torch.cuda.device(dev):
        err = _lib().lh_fused_aug_targets(
            images_u8.data_ptr(), params.data_ptr(), joints.data_ptr(),
            joints.stride(0), joints.stride(1), out.data_ptr(),
            int(out_dtype == torch.bfloat16), targets.data_ptr(), b, h, w, j,
            heatmap_size, tmp, inv, stride, geo.cluster, geo.threads,
            geo.groups, torch.cuda.current_stream().cuda_stream)
        fused_aug_targets_cuda.launches += 1
    if err:
        raise RuntimeError(f"fused_aug kernel launch failed: CUDA error {err}")
    return out, targets


fused_aug_targets_cuda.launches = 0
