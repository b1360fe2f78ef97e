"""Everything a run feeds the program, made from ``--seed``: the seeds of
each stream, the weights (on the device, a few large calls), and a pool
of hand images with their joints (joints on the host from a frozen copy
of LightHand's synthetic hand, images drawn on the device).

The same seed gives the same inputs on the same device. The program and
the reference receive the same tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
from torch import nn

POOL = 16  # distinct microbatches (or eval batches) a run cycles through


@dataclasses.dataclass(frozen=True)
class Seeds:
    weights: int
    data: int
    images: int
    steps: int


def seeds(seed: int) -> Seeds:
    """Independent 32-bit seeds for each stream of a run's ``seed`` (any
    non-negative whole number)."""
    state = np.random.SeedSequence(int(seed)).generate_state(4)
    return Seeds(*(int(s) for s in state))


def synth_hand_joints(rng: np.random.Generator, size: int) -> np.ndarray:
    """A plausible 21x2 hand in pixels: a frozen copy of LightHand's
    ``data/synthetic.py:synth_hand_joints`` (wrist, then 4 joints a finger
    from the thumb), clipped 4 px inside the image."""
    center = rng.uniform(0.35 * size, 0.65 * size, size=2)
    palm_r = rng.uniform(0.10, 0.16) * size
    base_angle = rng.uniform(0, 2 * np.pi)
    joints = np.zeros((21, 2), dtype=np.float32)
    joints[0] = center
    spread = np.deg2rad(22.0)
    for f in range(5):
        ang = base_angle + (f - 2) * spread + rng.normal(0, 0.08)
        seg = palm_r * np.array([0.9, 0.55, 0.4, 0.33])
        seg *= rng.uniform(0.85, 1.15, size=4)
        curl = rng.uniform(-0.25, 0.45)
        pos = center.copy()
        a = ang
        for k in range(4):
            a += curl * 0.5 * k
            pos = pos + seg[k] * np.array([np.cos(a), np.sin(a)])
            joints[1 + f * 4 + k] = pos
    return np.clip(joints, 4, size - 4).astype(np.float32)


PARENTS = (-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17,
           18, 19)


def render(joints: torch.Tensor, generator: torch.Generator,
           size: int, chunk: int = 8) -> torch.Tensor:
    """u8 [N, size, size, 3] hands on the device, as LightHand's
    ``render_hand`` draws them: a noisy background in [30, 90), a red and
    green blob at each joint, blue bones of six points each."""
    n, dev = joints.shape[0], joints.device
    img = torch.randint(30, 90, (n, size, size, 3), generator=generator,
                        device=dev, dtype=torch.uint8)
    t = torch.linspace(0, 1, 6, device=dev)
    parents = torch.tensor(PARENTS[1:], device=dev)
    grid = torch.arange(size, device=dev, dtype=torch.float32)
    for lo in range(0, n, chunk):
        j = joints[lo:lo + chunk].float()
        p0, p1 = j[:, parents], j[:, 1:]
        bones = (p0[:, :, None] * (1 - t[:, None])
                 + p1[:, :, None] * t[:, None]).flatten(1, 2)

        def field(points, sigma):
            dx = grid[None, None, None, :] - points[..., 0, None, None]
            dy = grid[None, None, :, None] - points[..., 1, None, None]
            return torch.exp(-(dx * dx + dy * dy)
                             / (2 * sigma * sigma)).sum(1)

        blobs = field(j, 5.0)
        add = torch.stack([160.0 * blobs, 120.0 * blobs,
                           60.0 * field(bones, 3.0)], dim=-1)
        img[lo:lo + chunk] = torch.clamp(
            img[lo:lo + chunk].float() + add, 0, 255).to(torch.uint8)
    return img


def pool(batch: int, size: int, aug_share: float, s: Seeds,
         device: torch.device, count: int = POOL) -> Dict[str, torch.Tensor]:
    """``count`` microbatches of ``batch`` hands on ``device``:
    ``image_u8`` [count, B, size, size, 3], ``joints`` [count, B, 21, 2]
    f32, ``aug_enabled`` [count, B] (1 on a seeded ``aug_share`` of the
    samples) and ``noise_enabled`` [count, B] (0)."""
    rng = np.random.default_rng(s.data)
    joints = np.stack([synth_hand_joints(rng, size)
                       for _ in range(count * batch)])
    joints = torch.from_numpy(joints).to(device)
    gen = torch.Generator(device=device).manual_seed(s.images)
    images = render(joints, gen, size)
    aug = (torch.rand((count, batch), generator=gen, device=device)
           < aug_share).float()
    return {"image_u8": images.reshape(count, batch, size, size, 3),
            "joints": joints.reshape(count, batch, 21, 2),
            "aug_enabled": aug,
            "noise_enabled": torch.zeros((count, batch), device=device)}


def weights(model: nn.Module, seed: int,
            device: torch.device) -> Dict[str, torch.Tensor]:
    """Seeded weights for every entry of ``model``'s state dict (``model``
    may live on the meta device), made on ``device`` in one draw, each
    drawn entry uniform in +-``bound`` (torch's default init, which
    LightHand's reference never replaces):

    - a conv or deconv weight (rank 4): bound 1 / sqrt(fan-in), fan-in
      ``shape[1] * kh * kw``;
    - a linear weight (rank 2, ``.weight``): bound 1 / sqrt(``shape[1]``);
    - the ``.bias`` beside a drawn ``.weight``: that weight's bound;
    - an entry that ``model.FREE_STD`` names with its standard deviation
      (a position embedding, a class token): the uniform of that standard
      deviation, bound std * sqrt(3).

    Every other entry is constant: a rank-1 ``.weight`` (BatchNorm's and
    LayerNorm's scale) and BatchNorm's running variance 1; shifts,
    running means and counters 0. An entry of rank 2 or more that no rule
    covers raises ValueError, as does a ``FREE_STD`` name that is not in
    the state dict."""
    state = model.state_dict()
    free = getattr(model, "FREE_STD", {})
    unknown = sorted(set(free) - set(state))
    if unknown:
        raise ValueError(f"FREE_STD names entries the model lacks: {unknown}")
    drawn = {}
    for name, t in state.items():
        if name in free:
            drawn[name] = free[name] * math.sqrt(3.0)
        elif t.ndim == 4:  # conv [out, in, kh, kw], deconv [in, out, kh, kw]
            drawn[name] = 1.0 / math.sqrt(t.shape[1] * t.shape[2]
                                          * t.shape[3])
        elif t.ndim == 2 and name.endswith(".weight"):  # linear [out, in]
            drawn[name] = 1.0 / math.sqrt(t.shape[1])
        elif t.ndim >= 2:
            raise ValueError(f"no rule draws {name} {tuple(t.shape)}: name "
                             f"it in the model's FREE_STD")
    for name, t in state.items():
        base = name.rsplit(".", 1)[0]
        if name.endswith(".bias") and f"{base}.weight" in drawn:
            drawn[name] = drawn[f"{base}.weight"]
    total = sum(state[n].numel() for n in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, t in state.items():
        if name in drawn:
            n = t.numel()
            out[name] = ((flat[at:at + n] * 2 - 1) * drawn[name]).reshape(
                t.shape)
            at += n
        elif name.endswith(("running_var", ".weight")):
            out[name] = torch.ones(t.shape, dtype=t.dtype, device=device)
        else:  # shifts, running means, num_batches_tracked
            out[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def load_program(model: nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into every entry of ``model``'s state dict; the
    names must match exactly."""
    state = model.state_dict()
    if set(state) != set(values):
        missing = sorted(set(state) ^ set(values))[:5]
        raise ValueError(f"the program's state dict and the reference's "
                         f"differ, e.g. {missing}")
    with torch.no_grad():
        for name, t in state.items():
            t.copy_(values[name])
