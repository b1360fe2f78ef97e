"""Heatmap -> keypoint decoding: counterpart of ``lighthand_tpu/ops/decode.py``
(reference ``get_max_preds``, src/utils/loss.py:327-355)."""

from __future__ import annotations

import torch


def get_max_preds(batch_heatmaps: torch.Tensor):
    """Argmax decode of [B, J, H, W].

    Returns preds [B, J, 2] (x, y) f32 in heatmap coordinates, zeroed where
    the max value is <= 0 (loss.py:351-354), and maxvals [B, J, 1]. A tie
    resolves to the first index, as ``jnp.argmax`` does."""
    b, j, h, w = batch_heatmaps.shape
    flat = batch_heatmaps.reshape(b, j, h * w)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)
    x = (idx % w).float()
    y = torch.floor(idx.float() / w)
    preds = torch.stack([x, y], dim=-1)
    preds = preds * (maxvals > 0.0).float()[..., None]
    return preds, maxvals[..., None]
