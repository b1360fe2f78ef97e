"""Train, eval and predict steps.

Counterpart of ``lighthand_tpu/train/step.py``. Batches use the JAX
package's layout: images NHWC (u8 for the fused step, normalised float for
the others), joints ``[B, J, 2(+1)]`` in pixels. Inside, an NHWC image is
viewed as NCHW with ``permute(0, 3, 1, 2)``, which is ``channels_last``
memory with no copy.

On the card the MSRA targets come from the CUDA kernels: K1 (fused
augmentation + targets) in ``make_fused_train_step``, K2 (targets) in
``make_targets``, i.e. the eval step, ``make_train_step`` and the fused
step's chain route. The max-combine targets of the "max" and "per_sample"
styles are plain PyTorch (``ops/heatmap.py``), as the JAX package computes
them in jnp.

With ``flip`` or ``rot_deg > 0`` the fused step takes the JAX package's own
jnp chain instead of K1 (``lighthand_tpu/train/step.py:151-227``):
jitter and noise (``ops/color.py``), rotation, normalize, flip
(``ops/affine.py``), then ``make_targets`` on the moved joints. It draws
the jitter and noise exactly as K1's route does, then the flip mask, then
the degrees, from the same generator.

Under a device mesh (``core/mesh.py``) each process holds its data index's
rows of the global batch: the draws are those of the global batch, sliced;
the reported loss and the eval step's (sum, count) pairs are reduced over
the data axis.
"""

from __future__ import annotations

import logging
from typing import Dict

import torch

from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.mesh import (
    average_gradients,
    data_group,
    data_index,
)
from lighthand_tpu_torch.ops.affine import hflip_px, rotate_px_batch
from lighthand_tpu_torch.ops.color import (
    channel_pixel_noise,
    color_jitter,
    divide,
    normalize_imagenet,
)
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
_log = logging.getLogger("lighthand_tpu_torch")


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
    """Forward in train mode, 0.5 * MSE, backward, the gradients of a
    replicated model averaged over the data axis, one Adam step."""
    state.model.train()
    loss = joints_mse_loss(state.model(images_nchw), targets)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if state.grad_group is not None:
        average_gradients(state.model.parameters(), state.grad_group)
    state.apply_gradients()
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


def draw_affine_params(generator: torch.Generator, batch: int,
                       flip: bool = False, rot_deg: float = 0.0):
    """The chain route's own draws, made after ``draw_aug_params``'s: the
    flip mask [B] (Bernoulli 0.5) when ``flip``, then the degrees [B]
    (U[-rot_deg, rot_deg]) when ``rot_deg > 0``; None for a draw that is
    off (it then consumes nothing)."""
    dev = generator.device
    mask = (torch.rand(batch, generator=generator, device=dev) < 0.5
            if flip else None)
    degrees = (-rot_deg + 2.0 * rot_deg * torch.rand(
        batch, generator=generator, device=dev) if rot_deg > 0 else None)
    return mask, degrees


def chain_augment(images_u8: torch.Tensor, joints: torch.Tensor,
                  params: torch.Tensor, flip_mask: torch.Tensor | None = None,
                  degrees: torch.Tensor | None = None,
                  out_dtype: torch.dtype = torch.bfloat16):
    """The chain route's arithmetic, in ``_one``'s order
    (``lighthand_tpu/train/step.py:216-224``): u8/255, jitter and noise
    from K1's packed draws ``params`` [B, 12], rotation by ``degrees``,
    ImageNet normalize and the cast to ``out_dtype``, the flip where
    ``flip_mask`` is set. Returns (images NHWC, joints moved with them)."""
    img = divide(images_u8.float(), 255.0)
    img = color_jitter(img, params[:, 1:5], params[:, 5:9].to(torch.int32),
                       enable=params[:, 0])
    img = channel_pixel_noise(img, params[:, 9:12])
    if degrees is not None:
        img, joints = rotate_px_batch(img, joints, degrees)
    images = normalize_imagenet(img).to(out_dtype)
    if flip_mask is not None:
        images, joints = hflip_px(images, joints, flip_mask)
    return images, joints


def _rows_of(x: torch.Tensor | None, index: int, count: int):
    """``x`` [b] as the ``index``-th of ``count`` row blocks of a zero
    [b * count] vector (None stays None)."""
    if x is None or count == 1:
        return x
    b = x.shape[0]
    full = x.new_zeros((b * count,) + tuple(x.shape[1:]))
    full[index * b:(index + 1) * b] = x
    return full


def _mean_over(x: torch.Tensor, group, count: int) -> torch.Tensor:
    """The mean of ``x`` over the data axis (``x`` itself with one index)."""
    if group is None:
        return x
    x = x.detach().clone()
    torch.distributed.all_reduce(x, group=group)
    return x / count


def make_fused_train_step(heatmap_size: int = 64, stride: float = 4.0,
                          sigma: float = 2.0, jitter: bool = True,
                          scan_steps: int = 1, target_style: str = "msra",
                          flip: bool = False, rot_deg: float = 0.0,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          device=None, mesh=None):
    """Fused train step: u8 batch -> K1 (per-sample ColorJitter gated by
    ``aug_enabled``, channel noise gated by ``noise_enabled``, ImageNet
    normalize to ``compute_dtype``, MSRA targets) -> forward/backward ->
    Adam. For ``target_style`` "max" the targets are replaced by the
    max-combine maps, for "per_sample" where the batch's ``hm_max`` is set.
    ``flip`` (random horizontal flips, p = 0.5) or ``rot_deg > 0``
    (rotation by U[-rot_deg, rot_deg] about the centre) take the chain
    route instead of K1 (``chain_augment``, then ``make_targets``: K2 for
    MSRA targets on the card), as the JAX package does; the step logs that
    once when it is built.

    Returns step(state, generator, batch) -> (state, {"loss"}); the batch
    has image_u8 [K?, B, H, W, 3] u8, joints [K?, B, J, 2+], aug_enabled
    and optional noise_enabled [K?, B] (and hm_max [K?, B] for
    "per_sample"), with the leading K only when ``scan_steps`` > 1. The
    draws come from ``generator``. With K > 1 the step runs K optimizer
    steps in order and reports their mean loss. ``state`` is updated in
    place. Under ``mesh`` the batch is this process's rows of the global
    batch and the loss is the global batch's."""
    _check_style(target_style)
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    device = resolve_device(device)
    index, count = data_index(mesh)
    group = data_group(mesh)
    chain = flip or rot_deg > 0
    if chain:
        _log.warning(
            "flip / rot-aug: the fused aug + target kernel (K1) is off for "
            "this step; the jitter -> rotate -> normalize -> flip chain runs "
            "instead, with its targets from make_targets")

    def draws(generator, aug_enabled, noise_enabled):
        """This process's rows of the global batch's draws: K1's packed
        jitter and noise, then the flip mask and the degrees."""
        b = aug_enabled.shape[0]
        params = draw_aug_params(generator,
                                 _rows_of(aug_enabled, index, count),
                                 _rows_of(noise_enabled, index, count))
        mask, degrees = draw_affine_params(generator, b * count, flip,
                                           rot_deg)
        rows = slice(index * b, (index + 1) * b)
        return [None if x is None else x[rows].to(device)
                for x in (params, mask, degrees)]

    def one(state, generator, images_u8, joints, aug_enabled, noise_enabled,
            hm_max):
        if not jitter:
            aug_enabled = torch.zeros_like(aug_enabled)
        params, mask, degrees = draws(generator, aug_enabled, noise_enabled)
        if chain:
            images, joints = chain_augment(images_u8, joints, params, mask,
                                           degrees, out_dtype=compute_dtype)
            targets = make_targets(joints, style=target_style,
                                   heatmap_size=heatmap_size, stride=stride,
                                   sigma=sigma, hm_max=hm_max)
        else:
            images, targets = fused_aug_targets_cuda(
                images_u8, joints, params, heatmap_size, stride, sigma,
                out_dtype=compute_dtype)
            targets = _max_style(joints, targets, target_style, heatmap_size,
                                 stride, hm_max)
        return _mean_over(_update(state, _nchw(images), targets), group,
                          count)

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
                   target_style: str = "msra", device=None, mesh=None):
    """Returns eval_step(state, batch) -> metrics (reference validation
    branch, method.py:218-287): loss, argmax decode x stride, PCK@pck_t
    (proportion) and EPE, each as a (sum, count) pair. batch["valid"]
    (optional, 0/1 per sample) masks the padded rows of a ragged batch.
    Under ``mesh`` the pairs are summed over the data axis before they are
    divided; ``pred_joints`` stays this process's rows."""
    _check_style(target_style)
    device = resolve_device(device)
    group = data_group(mesh)

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
        if group is not None:
            sums = torch.stack([loss_sum, n_valid, pck_sum, pck_cnt, epe_sum,
                                epe_cnt]).float()
            torch.distributed.all_reduce(sums, group=group)
            loss_sum, n_valid, pck_sum, pck_cnt, epe_sum, epe_cnt = sums
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
