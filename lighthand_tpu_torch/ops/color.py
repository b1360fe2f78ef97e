"""Color augmentation and normalization, plain PyTorch.

Counterpart of ``lighthand_tpu/ops/color.py`` and of the color part of
``lighthand_tpu/ops/pallas/fused_aug.py:_kernel``: torchvision-style
ColorJitter (brightness, contrast, saturation, hue via HSV) in a per-sample
order, FreiHAND per-channel noise, ImageNet normalize. Images are float in
[0, 1], channels last: ``[..., H, W, 3]``.

The op functions take their draws as arguments (factors, the op order and
the enable gates), so they are also the plain twin of the CUDA kernel.
``draw_jitter`` makes the jitter draws from a ``torch.Generator`` (for
``color_jitter_batch`` and ``ops/kernels/fused_aug.py:draw_aug_params``). The
arithmetic follows the JAX kernel op for op (gray = 0.299 r + 0.587 g +
0.114 b left to right; divisions kept as divisions; the hue modulo is a
floor modulo).
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)

BRIGHTNESS, CONTRAST, SATURATION, HUE = range(4)  # op index in the order


def _per_image(f, img: torch.Tensor, trailing: int = 3):
    """A per-image factor ([...] or scalar) broadcast over ``trailing`` dims."""
    if isinstance(f, torch.Tensor) and f.ndim:
        return f.reshape(f.shape + (1,) * trailing)
    return f


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once. On CUDA, PyTorch turns a Python-scalar
    divisor into a multiply by its reciprocal (two roundings); a tensor
    divisor divides, as the JAX package and the CUDA kernel do."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _gray(img: torch.Tensor) -> torch.Tensor:
    w0, w1, w2 = GRAY_WEIGHTS
    return w0 * img[..., 0] + w1 * img[..., 1] + w2 * img[..., 2]


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(img - mean) / std per channel; img [..., 3] float in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img.float() - mean) / std


def denormalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """img * std + mean per channel, in f32, two roundings (the inverse of
    ``normalize_imagenet`` up to rounding)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return img.float() * std + mean


def adjust_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    return torch.clamp(img * _per_image(factor, img), 0.0, 1.0)


def adjust_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """Blend with the mean of each image's grayscale (torchvision)."""
    mean = _per_image(_gray(img).mean(dim=(-2, -1)), img)
    return torch.clamp(mean + _per_image(factor, img) * (img - mean),
                       0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor) -> torch.Tensor:
    gray = _gray(img)[..., None]
    return torch.clamp(gray + _per_image(factor, img) * (img - gray),
                       0.0, 1.0)


def adjust_hue(img: torch.Tensor, delta) -> torch.Tensor:
    """Shift hue by ``delta`` (fraction of the full circle) via RGB<->HSV."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    spread = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, spread / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(spread, 1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # torch's float % is a floor modulo, like jnp's (C fmod is not)
    h = divide(h, 6.0) % 1.0
    h = torch.where(spread > 0, h, zero)
    h = (h + _per_image(delta, img, 2)) % 1.0

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6

    def sel(*cands):
        out = cands[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, cands[k], out)
        return out

    return torch.stack([sel(v, q, p, p, t, v), sel(t, v, v, q, p, p),
                        sel(p, p, t, v, v, q)], dim=-1)


_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def color_jitter(img: torch.Tensor, factors: torch.Tensor,
                 order: torch.Tensor, enable=1.0) -> torch.Tensor:
    """ColorJitter with given draws.

    img [..., H, W, 3] in [0, 1]; factors [..., 4] = (brightness, contrast,
    saturation, hue); order [..., 4] = op index (``BRIGHTNESS`` ..
    ``HUE``) per slot, clamped to that range as ``lax.switch`` clamps it in
    the JAX kernel; enable [...] or scalar gates each image as
    ``out * enable + img * (1 - enable)``. Every op is computed for every
    slot and the image's own is selected, which keeps a batch free of
    per-sample control flow."""
    order = order.clamp(BRIGHTNESS, HUE)
    out = img
    for slot in range(4):
        op = _per_image(order[..., slot], img)
        cands = [fn(out, factors[..., k]) for k, fn in enumerate(_OPS)]
        out = cands[HUE]
        for k in (SATURATION, CONTRAST, BRIGHTNESS):
            out = torch.where(op == k, cands[k], out)
    e = _per_image(enable, img)
    return out * e + img * (1.0 - e)


def channel_pixel_noise(img: torch.Tensor, factors: torch.Tensor,
                        enable=1.0) -> torch.Tensor:
    """FreiHAND per-channel multiplicative noise (frei_dataloader.py:118,
    142-144): factors [..., 3], gated as ``factors * enable + (1 -
    enable)``, then clipped to [0, 1]."""
    e = _per_image(enable, img, 1)
    pn = factors * e + (1.0 - e)
    return torch.clamp(img * pn[..., None, None, :], 0.0, 1.0)


def draw_jitter(generator: torch.Generator, b: int, brightness: float = 0.5,
                contrast: float = 0.5, saturation: float = 0.5,
                hue: float = 0.5):
    """Per-sample ColorJitter draws on the generator's device, in the ranges
    of ``lighthand_tpu/ops/color.py:108-123``: (factors f32 [b, 4], each of
    brightness, contrast and saturation uniform in [max(0, 1 - r), 1 + r)
    and hue in [-hue, hue); order int64 [b, 4], a random permutation of the
    4 ops). One ``rand`` of [b, 4] for the factors, then one for the
    order."""
    dev = generator.device
    lo = [max(0.0, 1.0 - r) for r in (brightness, contrast, saturation)]
    width = [1.0 + r - low for r, low in zip((brightness, contrast,
                                              saturation), lo)]
    lo = torch.tensor(lo + [-hue], dtype=torch.float32, device=dev)
    width = torch.tensor(width + [2.0 * hue], dtype=torch.float32, device=dev)
    u = torch.rand((b, 4), generator=generator, device=dev)
    factors = lo + width * u
    order = torch.argsort(torch.rand((b, 4), generator=generator, device=dev),
                          dim=1)
    return factors, order


def color_jitter_batch(imgs: torch.Tensor, enable, *, brightness: float = 0.5,
                       contrast: float = 0.5, saturation: float = 0.5,
                       hue: float = 0.5,
                       generator: torch.Generator | None = None,
                       factors: torch.Tensor | None = None,
                       order: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample ColorJitter of [B, H, W, 3] images in [0, 1] -> f32:
    ``draw_jitter``'s draws from ``generator``, then ``color_jitter``;
    ``enable`` [B] (or a scalar) gates each sample. ``factors`` [B, 4] and
    ``order`` [B, 4] replace the draws where given (torch cannot replay
    the JAX package's RNG, so its tests inject JAX's)."""
    if factors is None or order is None:
        if generator is None:
            raise ValueError("color_jitter_batch needs a generator, or both "
                             "factors and order")
        drawn = draw_jitter(generator, imgs.shape[0], brightness, contrast,
                            saturation, hue)
        factors = drawn[0] if factors is None else factors
        order = drawn[1] if order is None else order
    dev = imgs.device
    enable = torch.as_tensor(enable, dtype=torch.float32, device=dev)
    return color_jitter(imgs.float(), factors.to(dev, torch.float32),
                        order.to(dev), enable)
