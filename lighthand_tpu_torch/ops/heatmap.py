"""MSRA Gaussian heatmap targets, plain PyTorch.

Counterpart of ``lighthand_tpu/ops/heatmap.py:generate_target_batch``
(reference ``src/tools/dataset.py:165-212``): mu = int(p/stride + 0.5),
truncated toward zero; a 13x13 support |d| <= 3*sigma; the unnormalised
Gaussian exp(-(dx^2+dy^2) / (2 sigma^2)); a joint whose window lies wholly
outside the map gives a zero map. This is the plain twin of the CUDA
kernel in ``ops/kernels/heatmap.py``.

``generate_target`` is the single-sample form of the same target (K2 on a
CUDA tensor, the twin on a CPU one). ``generate_heatmap_max_batch`` is the
max-combine style of the GAN source and the Armo train/val phases.
"""

from __future__ import annotations

import torch

from lighthand_tpu_torch.ops.color import divide

HEATMAP_SIZE = 64
FEAT_STRIDE = 4.0
SIGMA = 2.0
TMP_SIZE = 6  # = 3 * sigma; Gaussian support is (2*6+1)^2 = 13x13


def pack_centers(joints: torch.Tensor, heatmap_size: int = HEATMAP_SIZE,
                 stride: float = FEAT_STRIDE,
                 sigma: float = SIGMA) -> torch.Tensor:
    """[B, J, 2+] pixel joints -> int32 [B, J, 3] = (mu_x, mu_y, valid).

    ``.to(int32)`` truncates toward zero like Python's ``int()``
    (dataset.py:178-179); floor would differ for negative joints. A joint is
    dropped iff ul >= H or br < 0 on either axis (dataset.py:181-185).
    The division is a true division on every device, as in the kernels
    (``ops/color.py:divide``)."""
    tmp = int(3 * sigma)
    mu = (divide(joints[..., :2].float(), stride) + 0.5).to(torch.int32)
    ul, br = mu - tmp, mu + tmp + 1
    valid = ~((ul[..., 0] >= heatmap_size) | (ul[..., 1] >= heatmap_size)
              | (br[..., 0] < 0) | (br[..., 1] < 0))
    return torch.cat([mu, valid.to(torch.int32)[..., None]], dim=-1)


def rasterize_centers(packed: torch.Tensor, heatmap_size: int = HEATMAP_SIZE,
                      sigma: float = SIGMA) -> torch.Tensor:
    """int32 [B, J, 3] packed centers -> f32 [B, J, H, H] targets."""
    tmp = int(3 * sigma)
    inv = 1.0 / (2.0 * sigma * sigma)
    idx = torch.arange(heatmap_size, dtype=torch.int32, device=packed.device)
    dx = idx[None, None, None, :] - packed[..., 0, None, None]
    dy = idx[None, None, :, None] - packed[..., 1, None, None]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2) * inv)
    support = (dx.abs() <= tmp) & (dy.abs() <= tmp)
    return g * support.float() * packed[..., 2, None, None].float()


def generate_target_batch(joints: torch.Tensor,
                          heatmap_size: int = HEATMAP_SIZE,
                          stride: float = FEAT_STRIDE,
                          sigma: float = SIGMA) -> torch.Tensor:
    """[B, J, 2+] -> f32 [B, J, H, H]."""
    return rasterize_centers(
        pack_centers(joints, heatmap_size, stride, sigma), heatmap_size,
        sigma)


def generate_target(joints: torch.Tensor, *,
                    heatmap_size: int = HEATMAP_SIZE,
                    stride: float = FEAT_STRIDE, sigma: float = SIGMA,
                    return_weight: bool = False):
    """MSRA target of one sample: joints [J, 2+] in input pixels -> f32
    [J, H, H], and with ``return_weight`` the [J] f32 weights (0 where the
    13x13 window lies wholly outside the map: ``pack_centers``'s valid
    column). On a CUDA tensor the maps come from K2 (one launch, B=1), on a
    CPU tensor from its plain twin."""
    # the kernel's module imports this one
    from lighthand_tpu_torch.ops.kernels.heatmap import (
        generate_target_batch_cuda,
    )

    joints = torch.as_tensor(joints)
    if not joints.is_floating_point():
        joints = joints.float()
    target = generate_target_batch_cuda(joints[None], heatmap_size, stride,
                                        sigma)[0]
    if not return_weight:
        return target
    valid = pack_centers(joints[None], heatmap_size, stride, sigma)[0, :, 2]
    return target, valid.float()


def generate_heatmap_max(joints: torch.Tensor, output_res: int = HEATMAP_SIZE,
                         num_parts: int = 21) -> torch.Tensor:
    """Max-combine targets for one sample, [J, 2+] joints in HEATMAP space
    -> f32 [num_parts, R, R]: ``lighthand_tpu/ops/heatmap.py:
    generate_heatmap_max`` (reference ``GenerateHeatmap.__call__``,
    src/datasets/frei_dataloader.py:17-46)."""
    return generate_heatmap_max_batch(joints[None], output_res, num_parts)[0]


def generate_heatmap_max_batch(joints_hm: torch.Tensor,
                               output_res: int = HEATMAP_SIZE,
                               num_parts: int = 21) -> torch.Tensor:
    """[B, J, 2+] joints in HEATMAP space (callers pass joints / stride, as
    the reference does: ``GenerateHeatmap(64, 21)(joint/4)``,
    dataset_loader.py:509) -> f32 [B, num_parts, R, R]. sigma = R/64; the
    center is the joint truncated toward zero; the window is
    |d| <= int(3 sigma + 1) around it; a joint counts only when x > 0 and
    its center lies in [0, R) on both axes. Plain PyTorch, as the JAX
    package computes it in jnp (no Pallas kernel)."""
    joints = joints_hm[..., :num_parts, :2].float()
    sigma = output_res / 64.0
    half = int(3 * sigma + 1)
    c = torch.trunc(joints).to(torch.int32)
    idx = torch.arange(output_res, dtype=torch.int32, device=joints.device)
    dx = idx[None, None, None, :] - c[..., 0, None, None]
    dy = idx[None, None, :, None] - c[..., 1, None, None]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2) / (2.0 * sigma ** 2))
    support = (dx.abs() <= half) & (dy.abs() <= half)
    valid = ((joints[..., 0] > 0) & (c[..., 0] >= 0) & (c[..., 1] >= 0)
             & (c[..., 0] < output_res) & (c[..., 1] < output_res))
    return g * support.float() * valid.float()[..., None, None]
