"""The reference's training and evaluation, plain float32 PyTorch with TF32
off.

``follow_training`` runs what LightHand's fused train step runs for each
microbatch (the draws, ColorJitter and noise, normalisation, Gaussian
targets, the forward in train mode, 0.5 x the mean squared error, the
backward, one Adam step with torch's defaults) and records what the
benchmark compares: every microbatch's loss, each parameter's gradient
norm at the first step, and each parameter's change from the start after
chosen steps. ``evaluate`` runs the validation branch on a batch: the
normalisation, the targets, the forward in eval mode, the loss sum and
the heatmaps. ``calibrate`` sets each BatchNorm's running statistics to
those of a batch. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List

import torch
from torch import nn

from reference import aug

BETAS = (0.9, 0.999)
EPS = 1e-8


@contextlib.contextmanager
def full_f32():
    """TF32 off for convs and matmuls inside; the switches restored on
    exit."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def load(model: nn.Module, weights: Dict[str, torch.Tensor],
         device: torch.device) -> nn.Module:
    """``model`` (on the meta device or the host) on ``device`` with
    ``weights`` (parameters and any buffers, by name) copied in."""
    model.to_empty(device=device)
    state = model.state_dict()
    with torch.no_grad():
        for name, value in weights.items():
            state[name].copy_(value)
    return model


def leaf_norms(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """The f32 2-norm of each tensor, as one vector."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])


def follow_training(model: nn.Module, microbatches: List[dict],
                    generator: torch.Generator, *, heatmap_size: int,
                    stride: float, sigma: float, lr: float,
                    change_after: Iterable[int]) -> dict:
    """Train ``model`` (f32, its seeded weights loaded) over
    ``microbatches`` (``image_u8``, ``joints``, ``aug_enabled``,
    ``noise_enabled``), drawing from ``generator`` as the program draws,
    one optimizer step a microbatch. Returns
    ``losses`` [n], ``grad1`` (each parameter's gradient norm at step 1)
    and ``change`` {step: each parameter's norm of change from the start
    after that step}."""
    params = [p for p in model.parameters()]
    start = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    wanted = set(change_after)
    losses, change, grad1 = [], {}, None
    model.train()
    with full_f32():
        for i, mb in enumerate(microbatches):
            factors, order, gate, noise = aug.draw(
                generator, mb["aug_enabled"], mb["noise_enabled"])
            x = aug.augment(mb["image_u8"], factors, order, gate, noise)
            target = aug.targets(mb["joints"], heatmap_size, stride, sigma)
            out = model(x.permute(0, 3, 1, 2))
            loss = 0.5 * ((out - target) ** 2).mean()
            losses.append(loss.detach())
            model.zero_grad(set_to_none=True)
            loss.backward()
            step = i + 1
            with torch.no_grad():
                grads = [p.grad for p in params]
                if step == 1:
                    grad1 = leaf_norms(grads)
                c1, c2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
                for p, g, mi, vi in zip(params, grads, m, v):
                    mi.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    vi.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = (vi.sqrt() / c2 ** 0.5).add_(EPS)
                    p.addcdiv_(mi, denom, value=-lr / c1)
                if step in wanted:
                    change[step] = leaf_norms(p - s
                                              for p, s in zip(params, start))
    return {"losses": torch.stack(losses), "grad1": grad1, "change": change}


def calibrate(model: nn.Module, images_u8: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and (biased) variance to those
    of its input on ``images_u8`` in a train-mode forward of ``model``."""
    def hook(module, inputs):
        var, mean = torch.var_mean(inputs[0], dim=(0, 2, 3), correction=0)
        module.running_mean.copy_(mean)
        module.running_var.copy_(var)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    model.train()
    try:
        with torch.no_grad(), full_f32():
            model(aug.normalize(images_u8.float() / 255.0)
                  .permute(0, 3, 1, 2))
    finally:
        for h in handles:
            h.remove()


def evaluate(model: nn.Module, images_u8: torch.Tensor,
             joints: torch.Tensor, *, heatmap_size: int, stride: float,
             sigma: float) -> dict:
    """The validation branch on one batch, every row valid: ``loss_sum``
    (the sum over samples of 0.5 x each sample's mean squared error) and
    the ``heatmaps`` [B, J, H, W]."""
    model.eval()
    with torch.no_grad(), full_f32():
        x = aug.normalize(images_u8.float() / 255.0).permute(0, 3, 1, 2)
        out = model(x)
        target = aug.targets(joints, heatmap_size, stride, sigma)
        per_sample = 0.5 * ((out - target) ** 2).mean(dim=(1, 2, 3))
    return {"loss_sum": per_sample.double().sum(), "heatmaps": out}
