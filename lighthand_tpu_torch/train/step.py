"""Train, eval and predict steps.

Counterpart of ``lighthand_tpu/train/step.py``. Batches use the JAX
package's layout: images NHWC (u8 for the fused step, normalised float for
the others), joints ``[B, J, 2(+1)]`` in pixels. Inside, an NHWC image is
viewed as NCHW with ``permute(0, 3, 1, 2)``, which is ``channels_last``
memory with no copy.

On the card the MSRA targets come from the CUDA kernels: K1 (fused
augmentation + targets) in ``make_fused_train_step``, K2 (targets) in
``make_targets``, i.e. the eval step and ``make_train_step``. The
max-combine targets of the "max" and "per_sample" styles are plain PyTorch
(``ops/heatmap.py``), as the JAX package computes them in jnp.

Not ported yet (ROADMAP.md, Queue 1): the ``flip`` / ``rot_deg``
augmentations; they raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.ops.decode import get_max_preds
from lighthand_tpu_torch.ops.heatmap import generate_heatmap_max_batch
from lighthand_tpu_torch.ops.kernels.fused_aug import (
    draw_aug_params,
    fused_aug_targets_cuda,
)
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda
from lighthand_tpu_torch.ops.metrics import (
    epe_train,
    epe_visible,
    joints_mse_loss,
    pck_2d_counts,
)
from lighthand_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]

TARGET_STYLES = ("msra", "max", "per_sample")
_LATER = "is not ported yet (ROADMAP.md, Queue 1: affine ops)"


def _check_style(style: str) -> None:
    if style not in TARGET_STYLES:
        raise ValueError(f"style must be one of {TARGET_STYLES}, got {style}")


def _max_style(joints_px: torch.Tensor, msra: torch.Tensor, style: str,
               heatmap_size: int, stride: float,
               hm_max: torch.Tensor | None) -> torch.Tensor:
    """The targets of ``style`` given the MSRA ones: "msra" keeps them,
    "max" replaces them with the max-combine maps of joints / stride,
    "per_sample" takes the max-combine maps where ``hm_max`` is set."""
    if style == "msra":
        return msra
    mx = generate_heatmap_max_batch(joints_px[..., :2] / stride,
                                    heatmap_size, joints_px.shape[-2])
    if style == "max":
        return mx
    if hm_max is None:
        raise ValueError("target style 'per_sample' needs batch['hm_max']")
    sel = hm_max.float()[:, None, None, None]
    return mx * sel + msra * (1.0 - sel)


def make_targets(joints_px: torch.Tensor, *, style: str = "msra",
                 heatmap_size: int = 64, stride: float = 4.0,
                 sigma: float = 2.0,
                 hm_max: torch.Tensor | None = None) -> torch.Tensor:
    """Targets [B, J, H, H] by dataset style: "msra" (src/tools/
    dataset.py:165-212) from the K2 kernel on a CUDA tensor, its plain twin
    on a CPU one; "max" the max-combine maps (frei_dataloader.py:17-46,
    the GAN source and the Armo train/val phases); "per_sample" selects by
    ``hm_max`` (mixed-source loaders)."""
    _check_style(style)
    msra = (None if style == "max" else
            generate_target_batch_cuda(joints_px[..., :2], heatmap_size,
                                       stride, sigma))
    return _max_style(joints_px, msra, style, heatmap_size, stride, hm_max)


def _nchw(images_nhwc: torch.Tensor) -> torch.Tensor:
    return images_nhwc.permute(0, 3, 1, 2)


def _to(x, device: torch.device):
    return None if x is None else torch.as_tensor(x).to(device,
                                                        non_blocking=True)


def _check_state(state: TrainState, device: torch.device) -> None:
    if state.device != device:
        raise ValueError(f"train state is on {state.device}, step built for "
                         f"{device}")


def _update(state: TrainState, images_nchw: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Forward in train mode, 0.5 * MSE, backward, one Adam step."""
    state.model.train()
    loss = joints_mse_loss(state.model(images_nchw), targets)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def make_train_step(heatmap_size: int = 64, stride: float = 4.0,
                    sigma: float = 2.0, device=None):
    """Returns train_step(state, batch) -> (state, {"loss"}) for a batch of
    normalised float images; updates ``state`` in place."""
    device = resolve_device(device)

    def train_step(state: TrainState, batch: Batch):
        _check_state(state, device)
        targets = make_targets(_to(batch["joints"], device),
                               heatmap_size=heatmap_size, stride=stride,
                               sigma=sigma)
        loss = _update(state, _nchw(_to(batch["image"], device)), targets)
        return state, {"loss": loss}

    return train_step


def make_fused_train_step(heatmap_size: int = 64, stride: float = 4.0,
                          sigma: float = 2.0, jitter: bool = True,
                          scan_steps: int = 1, target_style: str = "msra",
                          flip: bool = False, rot_deg: float = 0.0,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          device=None):
    """Fused train step: u8 batch -> K1 (per-sample ColorJitter gated by
    ``aug_enabled``, channel noise gated by ``noise_enabled``, ImageNet
    normalize to ``compute_dtype``, MSRA targets) -> forward/backward ->
    Adam. For ``target_style`` "max" the targets are replaced by the
    max-combine maps, for "per_sample" where the batch's ``hm_max`` is set.

    Returns step(state, generator, batch) -> (state, {"loss"}); the batch
    has image_u8 [K?, B, H, W, 3] u8, joints [K?, B, J, 2+], aug_enabled
    and optional noise_enabled [K?, B] (and hm_max [K?, B] for
    "per_sample"), with the leading K only when ``scan_steps`` > 1. The draws come from ``generator``. With K > 1 the
    step runs K optimizer steps in order and reports their mean loss.
    ``state`` is updated in place."""
    _check_style(target_style)
    if flip or rot_deg > 0:
        raise NotImplementedError(f"flip / rot_deg augmentation {_LATER}")
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    device = resolve_device(device)

    def one(state, generator, images_u8, joints, aug_enabled, noise_enabled,
            hm_max):
        if not jitter:
            aug_enabled = torch.zeros_like(aug_enabled)
        params = draw_aug_params(generator, aug_enabled, noise_enabled)
        images, targets = fused_aug_targets_cuda(
            images_u8, joints, params.to(device), heatmap_size, stride, sigma,
            out_dtype=compute_dtype)
        targets = _max_style(joints, targets, target_style, heatmap_size,
                             stride, hm_max)
        return _update(state, _nchw(images), targets)

    def step(state: TrainState, generator: torch.Generator, batch: Batch):
        _check_state(state, device)
        fields = [_to(batch[k], device)
                  for k in ("image_u8", "joints", "aug_enabled")]
        fields.append(_to(batch.get("noise_enabled"), device))
        fields.append(_to(batch.get("hm_max"), device)
                      if target_style == "per_sample" else None)
        if scan_steps == 1:
            return state, {"loss": one(state, generator, *fields)}
        if fields[0].shape[0] != scan_steps:
            raise ValueError(f"batch leading dim {fields[0].shape[0]} != "
                             f"scan_steps {scan_steps}")
        losses = [one(state, generator,
                      *(None if f is None else f[k] for f in fields))
                  for k in range(scan_steps)]
        return state, {"loss": torch.stack(losses).mean()}

    return step


def make_eval_step(heatmap_size: int = 64, stride: float = 4.0,
                   sigma: float = 2.0, pck_t: float = 0.2,
                   target_style: str = "msra", device=None):
    """Returns eval_step(state, batch) -> metrics (reference validation
    branch, method.py:218-287): loss, argmax decode x stride, PCK@pck_t
    (proportion) and EPE, each as a (sum, count) pair. batch["valid"]
    (optional, 0/1 per sample) masks the padded rows of a ragged batch."""
    _check_style(target_style)
    device = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        _check_state(state, device)
        joints = _to(batch["joints"], device)
        valid = _to(batch.get("valid"), device)
        w = (torch.ones(joints.shape[0], device=device) if valid is None
             else valid.float())
        targets = make_targets(joints, style=target_style,
                               heatmap_size=heatmap_size, stride=stride,
                               sigma=sigma,
                               hm_max=_to(batch.get("hm_max"), device))
        state.model.eval()
        pred = state.model(_nchw(_to(batch["image"], device))).float()
        per_sample = 0.5 * torch.mean((pred - targets) ** 2, dim=(1, 2, 3))
        n_valid = w.sum()
        loss_sum = (per_sample * w).sum()

        pred_joints = get_max_preds(pred)[0] * stride  # heatmap -> image px
        pck_sum, pck_cnt = pck_2d_counts(pred_joints, joints[..., :2],
                                         t=pck_t, threshold="proportion",
                                         sample_weight=w)
        epe = epe_visible if joints.shape[-1] > 2 else epe_train
        epe_sum, epe_cnt = epe(pred_joints, joints, sample_weight=w)
        return {
            "loss": loss_sum / torch.clamp_min(n_valid, 1.0),
            "loss_sum": loss_sum,
            "n_valid": n_valid,
            "pck": pck_sum / torch.clamp_min(pck_cnt, 1.0),
            "pck_sum": pck_sum,
            "pck_count": pck_cnt,
            "epe_sum": epe_sum,
            "epe_count": epe_cnt,
            "pred_joints": pred_joints,
        }

    return eval_step


def make_predict_step(stride: float = 4.0, device=None):
    """Inference: normalised NHWC images -> (joints in image pixels
    [B, J, 2], maxvals [B, J, 1])."""
    device = resolve_device(device)

    @torch.no_grad()
    def predict_step(state: TrainState, images: torch.Tensor):
        _check_state(state, device)
        state.model.eval()
        pred = state.model(_nchw(_to(images, device))).float()
        pred_joints, maxvals = get_max_preds(pred)
        return pred_joints * stride, maxvals

    return predict_step
