"""Training/validation metrics: counterpart of ``lighthand_tpu/ops/metrics.py``
(reference src/utils/loss.py), with the reference's quirks kept for parity:

- EPE scores joints 1..J-2 (the wrist is skipped by construction and the
  last joint by a range() off-by-one, loss.py:32,44);
- PCK counts a joint as correct when its normalised distance is NOT
  strictly greater than T (loss.py:104,138).

Every statistic the eval step accumulates is a (sum, count) pair, and
``sample_weight`` (0/1 per sample) masks the padded rows of a ragged batch.
``pck_2d``, ``pck_2d_visible``, ``pck_curve``, the 3D metric and the
keypoint losses are the library's scores of a whole batch (an eval
notebook's), as in the JAX package.
"""

from __future__ import annotations

import torch

from lighthand_tpu_torch.ops.color import divide

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


def _fraction(correct: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean of 0/1 ``correct`` (over ``dim``, or all of it) as its sum
    over a true division by the count, as ``jnp.mean`` computes it; CUDA's
    ``mean`` multiplies by the count's reciprocal, one rounding more, so a
    PCK on the card would differ from the CPU's in the last bit."""
    correct = correct.float()
    total = correct.sum() if dim is None else correct.sum(dim=dim)
    return divide(total, float(correct.numel() // max(1, total.numel())))


def _pck_correct(dist: torch.Tensor, gt_2d: torch.Tensor, t: float,
                 threshold: str) -> torch.Tensor:
    """Joints whose distance (over the bbox diagonal for 'proportion') is
    <= T, or whose px distance is <= T * 3.78 for 'mm'."""
    if threshold == "proportion":
        return (dist / bbox_diagonal(gt_2d)[:, None]) <= t
    if threshold == "mm":
        return dist <= (t * MM_SCALE_PCK)
    raise ValueError(f"threshold must be proportion|mm, got {threshold}")


def pck_2d(pred_2d: torch.Tensor, gt_2d: torch.Tensor, t: float = 0.1,
           threshold: str = "proportion") -> torch.Tensor:
    """PCK over all joints, wrist included (loss.py:116-148): pred_2d /
    gt_2d [B, J, 2+] -> f32 scalar in [0, 1]."""
    return _fraction(_pck_correct(_dist(pred_2d, gt_2d), gt_2d, t,
                                  threshold))


def pck_2d_counts(pred_2d: torch.Tensor, gt_2d: torch.Tensor, t: float = 0.1,
                  threshold: str = "proportion",
                  sample_weight: torch.Tensor | None = None):
    """(n_correct, n_total) of PCK over all joints, bbox-diagonal normalised
    ('proportion') or against T * 3.78 px ('mm') (loss.py:116-148)."""
    correct = _pck_correct(_dist(pred_2d, gt_2d), gt_2d, t, threshold).float()
    if sample_weight is None:
        return correct.sum(), torch.full((), float(correct.numel()),
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
        return dist.sum(), torch.full((), float(dist.numel()),
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


def pck_2d_visible(pred_2d: torch.Tensor, gt_2d_v: torch.Tensor,
                   t: float = 0.1, threshold: str = "proportion"
                   ) -> torch.Tensor:
    """PCK over the visible joints 1: (loss.py:83-114); gt_2d_v [B, J, 3]
    with a 0/1 visibility column. The bbox diagonal is taken over all GT
    joints; an invisible joint has its distance forced to 0 and is left out
    of the denominator."""
    vis = (gt_2d_v[:, 1:, 2] == 1).float()
    diag = bbox_diagonal(gt_2d_v)[:, None]
    dist = _dist(pred_2d[:, 1:], gt_2d_v[:, 1:]) * vis
    num_vis = vis.sum()
    if threshold == "proportion":
        incorrect = ((dist / diag) > t).float().sum()
    elif threshold == "mm":
        incorrect = (dist > (t * MM_SCALE_PCK)).float().sum()
    else:
        raise ValueError(f"threshold must be proportion|mm, got {threshold}")
    return (num_vis - incorrect) / (num_vis + torch.finfo(torch.float32).tiny)


def pck_curve(pred_2d: torch.Tensor, gt_2d: torch.Tensor,
              thresholds: torch.Tensor, threshold: str = "proportion"
              ) -> torch.Tensor:
    """PCK in % at each threshold of ``thresholds`` [T] (loss.py:150-202):
    f32 [T]; 'mm' divides the px distance by 3.78."""
    dist = _dist(pred_2d, gt_2d)
    if threshold == "proportion":
        norm = dist / bbox_diagonal(gt_2d)[:, None]
    elif threshold == "mm":
        norm = divide(dist, MM_SCALE_PCK)
    else:
        raise ValueError(f"threshold must be proportion|mm, got {threshold}")
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32,
                                 device=norm.device)
    return 100.0 * _fraction(norm[None] <= thresholds[:, None, None],
                             dim=(1, 2))


# the 3D metric surface (dormant in the reference's 2D path)

PX_TO_MM_PCK3D = 3.779527559  # loss.py:210 (one digit fewer than eval's)


def pck_3d(pred_3d: torch.Tensor, gt_3d: torch.Tensor, t: float = 0.1):
    """PCK over 3D joints, the distance scaled px -> mm and compared <= T
    (PCK_3d_loss, loss.py:205-213). Returns (pck, t)."""
    dist = torch.sqrt(torch.sum((pred_3d.float() - gt_3d.float()) ** 2,
                                dim=2))
    return _fraction(dist * PX_TO_MM_PCK3D <= t), t


def keypoint_2d_loss(pred_2d: torch.Tensor, gt_2d: torch.Tensor
                     ) -> torch.Tensor:
    """Squared error of the keypoints (loss.py:69-80). With a visibility
    column the errors are masked by it and averaged over the strictly
    positive ones only (the reference's ``loss[loss > 0].mean()``, with a
    floor of 1 in the denominator); without one, the plain mean."""
    pred, gt = pred_2d.float(), gt_2d.float()
    if gt.shape[2] > 2:
        err = (pred - gt[:, :, :2]) ** 2 * gt[:, :, 2][:, :, None]
        pos = (err > 0).float()
        return (err * pos).sum() / torch.clamp_min(pos.sum(), 1.0)
    return torch.mean((pred - gt) ** 2)


def keypoint_3d_loss(pred_3d: torch.Tensor, gt_3d: torch.Tensor
                     ) -> torch.Tensor:
    """Plain MSE over 3D keypoints (loss.py:225-236); an empty batch raises,
    as the reference's ``assert False`` branch does."""
    if gt_3d.shape[0] == 0:
        raise ValueError("gt_3d_keypoint No")  # reference loss.py:236
    return torch.mean((pred_3d.float() - gt_3d.float()) ** 2)
