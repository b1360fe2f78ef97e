"""The reference's data path in plain float32 PyTorch: the augmentation
draws, ColorJitter, channel noise, ImageNet normalisation, MSRA targets,
the argmax decode and the validation metrics.

It works out again what LightHand's fused step derives from a u8 batch:
the same draws from a ``torch.Generator`` seeded as the program's (the
same calls, shapes and order, so the same numbers on the same device),
then torchvision's ColorJitter (brightness, contrast, saturation, hue via
HSV) in each sample's drawn order, FreiHAND's per-channel noise, the
ImageNet mean and std, and the Gaussian targets of LightHand's
``dataset.py`` (mu = int(p / stride + 0.5), a 13x13 window at sigma 2, a
joint whose window misses the map gives a zero map). Nothing here imports
the program.
"""

from __future__ import annotations

import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
GRAY = (0.299, 0.587, 0.114)
JITTER = 0.5  # brightness, contrast, saturation and hue ranges


def draw(generator: torch.Generator, aug_enabled: torch.Tensor,
         noise_enabled: torch.Tensor):
    """One microbatch's draws: (factors [B, 4], order [B, 4], gate [B],
    noise [B, 3]): brightness, contrast and saturation factors in
    [0.5, 1.5), hue in [-0.5, 0.5), a random order of the four ops, then
    noise factors in [0.6, 1.4) where ``noise_enabled`` is set (1
    elsewhere)."""
    b = aug_enabled.shape[0]
    dev = generator.device
    lo = torch.tensor([1 - JITTER] * 3 + [-JITTER], device=dev)
    width = torch.tensor([2 * JITTER] * 4, device=dev)
    factors = lo + width * torch.rand((b, 4), generator=generator,
                                      device=dev)
    order = torch.argsort(torch.rand((b, 4), generator=generator,
                                     device=dev), dim=1)
    pn = 0.6 + 0.8 * torch.rand((b, 3), generator=generator, device=dev)
    noise = noise_enabled.to(dev, torch.float32)[:, None]
    return (factors, order, aug_enabled.to(dev, torch.float32),
            pn * noise + (1.0 - noise))


def _gray(img):
    return GRAY[0] * img[..., 0] + GRAY[1] * img[..., 1] + GRAY[2] * img[..., 2]


def _b(f, img, trailing=3):
    return f.reshape(f.shape + (1,) * trailing)


def brightness(img, f):
    return torch.clamp(img * _b(f, img), 0.0, 1.0)


def contrast(img, f):
    mean = _b(_gray(img).mean(dim=(-2, -1)), img)
    return torch.clamp(mean + _b(f, img) * (img - mean), 0.0, 1.0)


def saturation(img, f):
    gray = _gray(img)[..., None]
    return torch.clamp(gray + _b(f, img) * (img - gray), 0.0, 1.0)


def hue(img, delta):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    spread = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, spread / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(spread, 1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(spread > 0, (h / 6.0) % 1.0, zero)
    h = (h + _b(delta, img, 2)) % 1.0
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    v = maxc
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = i.to(torch.int64) % 6
    table = torch.stack([torch.stack(c, dim=-1) for c in (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q))])
    return torch.gather(table, 0, i[None, ..., None].expand(
        1, *i.shape, 3))[0]


OPS = (brightness, contrast, saturation, hue)


def augment(images_u8: torch.Tensor, factors, order, gate, noise):
    """u8 [B, H, W, 3] -> normalised f32 [B, H, W, 3]: ColorJitter in each
    sample's order where ``gate`` is 1, then the noise, then ImageNet's
    mean and std."""
    img0 = images_u8.float() / 255.0
    img = img0
    for slot in range(4):
        op = _b(order[:, slot], img)
        out = torch.zeros_like(img)
        for k, fn in enumerate(OPS):
            out = torch.where(op == k, fn(img, factors[:, k]), out)
        img = out
    g = _b(gate, img)
    img = img * g + img0 * (1.0 - g)
    img = torch.clamp(img * noise[:, None, None, :], 0.0, 1.0)
    return normalize(img)


def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=img.device)
    std = torch.tensor(STD, device=img.device)
    return (img - mean) / std


def targets(joints: torch.Tensor, size: int, stride: float,
            sigma: float) -> torch.Tensor:
    """[B, J, 2+] pixel joints -> f32 [B, J, size, size] Gaussian maps."""
    tmp = int(3 * sigma)
    mu = (joints[..., :2].float() / stride + 0.5).to(torch.int64)
    ul, br = mu - tmp, mu + tmp + 1
    valid = ~((ul[..., 0] >= size) | (ul[..., 1] >= size)
              | (br[..., 0] < 0) | (br[..., 1] < 0))
    idx = torch.arange(size, device=joints.device)
    dx = idx[None, None, None, :] - mu[..., 0, None, None]
    dy = idx[None, None, :, None] - mu[..., 1, None, None]
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2)
                  / (2.0 * sigma * sigma))
    keep = (dx.abs() <= tmp) & (dy.abs() <= tmp) & valid[..., None, None]
    return g * keep.float()


def decode(heatmaps: torch.Tensor):
    """Argmax of [B, J, H, W] -> (x, y) [B, J, 2] in map pixels, (0, 0)
    where the max is not positive; and the max [B, J]."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    val, idx = flat.max(dim=2)
    xy = torch.stack([idx % w, idx // w], dim=-1).float()
    return xy * (val > 0).float()[..., None], val


def metric_sums(pred_px: torch.Tensor, joints: torch.Tensor, t: float):
    """LightHand's validation sums (``loss.py``) of predictions
    [..., B, J, 2] against a batch's joints [B, J, 2+]: PCK at ``t`` of
    each sample's keypoint-box diagonal over all joints (correct when not
    farther), and the pixel EPE over joints 1..J-2. Returns (pck_sum,
    pck_count, epe_sum, epe_count), each [...]. Each distance and ratio
    is rounded to f32 as the published code computes it, so a joint at the
    threshold falls on the same side; the sums are f64."""
    gt = joints[..., :2].float()
    pred = pred_px.float()
    dist = torch.sqrt(((gt - pred) ** 2).sum(-1))
    wh = gt.amax(dim=1) - gt.amin(dim=1)
    diag = torch.sqrt((wh ** 2).sum(-1))
    pck = (dist / diag[:, None] <= t).double()
    epe = dist[..., 1:joints.shape[1] - 1].double()
    b, j = joints.shape[:2]
    return pck.sum((-2, -1)), float(b * j), epe.sum((-2, -1)), float(b * (j - 2))
