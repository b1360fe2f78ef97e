"""Training/validation metrics: counterpart of ``lighthand_tpu/ops/metrics.py``
(reference src/utils/loss.py), with the reference's quirks kept for parity:

- EPE scores joints 1..J-2 (the wrist is skipped by construction and the
  last joint by a range() off-by-one, loss.py:32,44);
- PCK counts a joint as correct when its normalised distance is NOT
  strictly greater than T (loss.py:104,138).

Every statistic the eval step accumulates is a (sum, count) pair, and
``sample_weight`` (0/1 per sample) masks the padded rows of a ragged batch.
"""

from __future__ import annotations

import torch

MM_SCALE_PCK = 3.78  # loss.py:107,141,179
PX_TO_MM_EVAL = 3.7795275591  # offline eval's EPE in mm (argparser.py:377,386,399)
MM_THRESH_SCALE_EVAL = 2.83464567  # offline eval's mm grid (argparser.py:336)
PX_TO_MM_VALID_LOG = 0.26  # the validation log's EPE in mm (method.py:131)


def bbox_diagonal(gt_2d: torch.Tensor) -> torch.Tensor:
    """Per-sample diagonal of the GT keypoint extent (loss.py:89-94):
    gt_2d [B, J, >=2] -> [B] f32."""
    xy = gt_2d[..., :2].float()
    wh = torch.amax(xy, dim=1) - torch.amin(xy, dim=1)
    return torch.sqrt(torch.sum(wh ** 2, dim=-1))


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.5 * global MSE (== the reference's per-joint mean, loss.py:315-325,
    since every joint map has the same size)."""
    return 0.5 * torch.mean((pred.float() - target.float()) ** 2)


def _dist(pred_2d: torch.Tensor, gt_2d: torch.Tensor) -> torch.Tensor:
    diff = gt_2d[..., :2].float() - pred_2d[..., :2].float()
    return torch.sqrt(torch.sum(diff ** 2, dim=-1))


def pck_2d_counts(pred_2d: torch.Tensor, gt_2d: torch.Tensor, t: float = 0.1,
                  threshold: str = "proportion",
                  sample_weight: torch.Tensor | None = None):
    """(n_correct, n_total) of PCK over all joints, bbox-diagonal normalised
    ('proportion') or against T * 3.78 px ('mm') (loss.py:116-148)."""
    dist = _dist(pred_2d, gt_2d)  # [B, J]
    if threshold == "proportion":
        correct = (dist / bbox_diagonal(gt_2d)[:, None]) <= t
    elif threshold == "mm":
        correct = dist <= (t * MM_SCALE_PCK)
    else:
        raise ValueError(f"threshold must be proportion|mm, got {threshold}")
    correct = correct.float()
    if sample_weight is None:
        return correct.sum(), torch.tensor(float(correct.numel()),
                                           device=correct.device)
    w = sample_weight.float()
    return (correct * w[:, None]).sum(), w.sum() * correct.shape[1]


def _epe_slice(num_joints: int) -> slice:
    return slice(1, num_joints - 1)


def epe_train(pred_2d: torch.Tensor, gt_2d: torch.Tensor,
              sample_weight: torch.Tensor | None = None):
    """(sum_px_error, count) over joints 1..J-2 whatever their visibility
    (loss.py:50-67)."""
    sl = _epe_slice(pred_2d.shape[1])
    dist = _dist(pred_2d[:, sl], gt_2d[:, sl])
    if sample_weight is None:
        return dist.sum(), torch.tensor(float(dist.numel()),
                                        device=dist.device)
    w = sample_weight.float()
    return (dist * w[:, None]).sum(), w.sum() * dist.shape[1]


def epe_visible(pred_2d: torch.Tensor, gt_2d_v: torch.Tensor,
                sample_weight: torch.Tensor | None = None):
    """(sum_px_error, count) over visible joints 1..J-2 (loss.py:28-47);
    gt_2d_v [B, J, 3] with a 0/1 visibility column."""
    sl = _epe_slice(pred_2d.shape[1])
    vis = (gt_2d_v[:, sl, 2] == 1).float()
    if sample_weight is not None:
        vis = vis * sample_weight.float()[:, None]
    dist = _dist(pred_2d[:, sl], gt_2d_v[:, sl]) * vis
    return dist.sum(), vis.sum()
