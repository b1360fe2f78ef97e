"""Procedural synthetic hand-pose data: a copy of
``lighthand_tpu/data/synthetic.py``, sample for sample the same bytes.

Used by smoke tests, the benchmark, and as a stand-in when the real dataset
trees (LightHand99K / FreiHAND / ...) are not mounted. Generates a plausible
21-joint kinematic hand (wrist + 5 fingers x 4 joints) rendered as soft
blobs and bones onto a noisy background, so models can genuinely learn and
overfit on it.
"""

from __future__ import annotations

import numpy as np

from lighthand_tpu_torch.data.records import Sample, Source

# Joint layout (matches the reference ordering: wrist, then 4 joints per
# finger thumb->pinky, visualize.py:15 parents array).
PARENTS = np.array(
    [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
)


def synth_hand_joints(rng: np.random.Generator, size: int = 256) -> np.ndarray:
    """Sample a random but anatomically-plausible 21x2 joint set, px coords."""
    center = rng.uniform(0.35 * size, 0.65 * size, size=2)
    palm_r = rng.uniform(0.10, 0.16) * size
    base_angle = rng.uniform(0, 2 * np.pi)
    joints = np.zeros((21, 2), dtype=np.float32)
    joints[0] = center
    finger_spread = np.deg2rad(22.0)
    for f in range(5):
        ang = base_angle + (f - 2) * finger_spread + rng.normal(0, 0.08)
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


def render_hand(joints: np.ndarray, rng: np.random.Generator,
                size: int = 256) -> np.ndarray:
    """Cheap rasterization: background noise + bone segments + joint blobs."""
    img = rng.integers(30, 90, size=(size, size, 3), dtype=np.uint8).astype(
        np.float32
    )
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    # joint blobs
    for j in range(21):
        d2 = (xx - joints[j, 0]) ** 2 + (yy - joints[j, 1]) ** 2
        img[..., 0] += 160.0 * np.exp(-d2 / (2 * 5.0**2))
        img[..., 1] += 120.0 * np.exp(-d2 / (2 * 5.0**2))
    # bones as capsule-ish fields (coarse: few sample points per bone)
    for j in range(1, 21):
        p0, p1 = joints[PARENTS[j]], joints[j]
        for t in np.linspace(0, 1, 6):
            c = p0 * (1 - t) + p1 * t
            d2 = (xx - c[0]) ** 2 + (yy - c[1]) ** 2
            img[..., 2] += 60.0 * np.exp(-d2 / (2 * 3.0**2))
    return np.clip(img, 0, 255).astype(np.uint8)


class SyntheticHands(Source):
    """Deterministic-by-index synthetic dataset."""

    def __init__(self, length: int = 1024, size: int = 256, seed: int = 9001,
                 with_visibility: bool = False, aug_ratio: float = 0.0):
        self.length = length
        self.size = size
        self.seed = seed
        self.with_visibility = with_visibility
        self.aug_ratio = aug_ratio

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> Sample:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        joints = synth_hand_joints(rng, self.size)
        image = render_hand(joints, rng, self.size)
        if self.with_visibility:
            vis = (rng.uniform(size=(21, 1)) > 0.15).astype(np.float32)
            vis[0] = 1.0  # wrist always visible
            joints = np.concatenate([joints, vis], axis=1)
        return Sample(
            image=image,
            joints=joints.astype(np.float32),
            aug_enabled=idx < self.length * self.aug_ratio,
            meta={"pose_ctgy": "Standard", "idx": idx},
        )
