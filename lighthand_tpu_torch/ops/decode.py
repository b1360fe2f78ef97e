"""Heatmap -> keypoint decoding: counterpart of ``lighthand_tpu/ops/decode.py``
(reference ``get_max_preds``, src/utils/loss.py:327-355), and the JAX
package's differentiable ``soft_argmax_preds``."""

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


def soft_argmax_preds(batch_heatmaps: torch.Tensor, temperature: float = 1.0):
    """Differentiable sub-pixel decode of [B, J, H, W]: the softmax of the
    flattened map (in f32, times ``temperature``) as weights of the grid's
    x and y. Returns preds [B, J, 2] (x, y) f32 and the raw map's max
    [B, J, 1] as the confidence. f64 maps stay f64 (a gradient check
    needs them)."""
    b, j, h, w = batch_heatmaps.shape
    dtype = torch.promote_types(batch_heatmaps.dtype, torch.float32)
    flat = batch_heatmaps.reshape(b, j, h * w).to(dtype)
    grid = torch.softmax(flat * temperature, dim=-1).reshape(b, j, h, w)
    xs = torch.arange(w, dtype=dtype, device=flat.device)
    ys = torch.arange(h, dtype=dtype, device=flat.device)
    ex = torch.einsum("bjhw,w->bj", grid, xs)
    ey = torch.einsum("bjhw,h->bj", grid, ys)
    conf = torch.amax(flat, dim=-1, keepdim=True)
    return torch.stack([ex, ey], dim=-1), conf
