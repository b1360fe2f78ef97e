"""Building blocks of the pose backbones, with the JAX package's numerics.

Counterpart of ``lighthand_tpu/models/layers.py``. Submodule names follow
the reference torch models (``conv1``/``bn1``, ``downsample.0``/``.1``), so
a ``state_dict`` of the port is a reference checkpoint.

Numerics that follow the JAX package rather than torch's habits:

- a conv runs in the dtype of its input (the policy's compute dtype) with
  its f32 weights cast to it; padding is k//2 on both sides;
- BatchNorm is computed in f32 and its output cast back to the input dtype;
  where a ReLU follows it directly, the ReLU is part of the BatchNorm
  (``BatchNorm2d(relu=True)``), applied before that one rounding. A
  residual block ends in its last BatchNorm too (``bn(x, residual=r)``):
  ``relu(bn(x) + r)`` in one pass on the card, rounded as the chain BN,
  cast, add, ReLU rounds (the BN output to the compute dtype, the f32 sum
  again), so its bits are that chain's; its backward gates the gradient by
  the saved output, as the ReLU's own backward does. On the card these run
  as the kernels of ``ops/kernels/batch_norm.py``; on the CPU as their
  plain twins, the formulas above;
- in training, the running variance is updated with the *biased* batch
  variance, as Flax's ``nn.BatchNorm`` does. ``nn.BatchNorm2d`` would use
  the unbiased one. Flax momentum 0.9 is torch momentum 0.1; eps is 1e-5;
- under a mesh whose data axis has more than one process, training
  BatchNorm normalises over the *global* batch, as the JAX package's pjit
  step does (one logical program), where DDP and FSDP would normalise per
  process: the per-channel sums are all-reduced over the data axis by a
  differentiable all-reduce, so the backward is global BN's too;
- under a policy with ``quant_fwd``, every conv the JAX package wraps in
  ``ConvBN`` (stems, block convs, downsamples, HRNet's transitions and
  fuse layers) is a ``QuantConv2d``: the same ``weight`` parameter and
  ``state_dict`` key, an int8 forward (``ops/quant.py``). A model's forward
  quantizes all their weights in one grouped call first
  (``quantized_weights``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from lighthand_tpu_torch.ops import quant
from lighthand_tpu_torch.ops.kernels.batch_norm import activate, batch_norm

BN_MOMENTUM = 0.1  # torch convention; == 1 - flax momentum 0.9
BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """Conv in the input's dtype; weights (and bias) cast to it per call."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding)


class QuantConv2d(Conv2d):
    """int8-forward conv (``ops/quant.py:int8_conv``, STE backward) with the
    parameters of the ``Conv2d`` it replaces, so the bf16 and int8_fwd
    policies share checkpoints. No bias: no backbone conv has one.

    Inside its model's forward it takes the (``w_q``, ``scale``) that
    ``quantized_weights`` made for that forward; called on its own, it
    quantizes its weight itself (a group of one)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 policy: DTypePolicy):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=kernel // 2, bias=False)
        self.act_clip = policy.act_clip
        self.compute_dtype = policy.compute_dtype
        self.quantized = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant.int8_conv(x, self.weight, self.stride[0],
                               self.padding[0], self.act_clip,
                               self.compute_dtype, self.quantized)


def quant_convs(model: nn.Module) -> tuple:
    """``model``'s ``QuantConv2d`` modules, in ``modules()`` order."""
    return tuple(m for m in model.modules() if isinstance(m, QuantConv2d))


@contextlib.contextmanager
def quantized_weights(convs: Sequence[QuantConv2d]) -> Iterator[None]:
    """For the span of a model's forward, each conv of ``convs`` holds the
    (``w_q``, ``scale``) of its weight, all made by one grouped call
    (``ops/quant.py:quantize_group``: one kernel launch on the card) before
    the first conv runs. They are cleared on exit, so no ``w_q`` outlives
    the forward that made it. Under FSDP2 the root's forward sees the
    unsharded weights, so the call does too."""
    if not convs:
        yield
        return
    # one policy builds a model, so its convs share one act_clip
    made = quant.quantize_group([c.weight for c in convs], convs[0].act_clip)
    # straight into each module's __dict__: nn.Module.__setattr__ costs
    # about 2 us a call, 1 ms a W32 forward
    try:
        for c, q in zip(convs, made):
            vars(c)["quantized"] = q
        yield
    finally:
        for c in convs:
            vars(c)["quantized"] = None


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = False, policy: DTypePolicy | None = None) -> Conv2d:
    """A conv with torch's padding k//2; a ``QuantConv2d`` where ``policy``
    (given only for the JAX package's ``ConvBN`` convs) has ``quant_fwd``."""
    if policy is not None and policy.quant_fwd:
        if bias:
            raise ValueError("a quantized conv has no bias")
        return QuantConv2d(cin, cout, kernel, stride, policy)
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  bias=bias)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group``, whose gradient is the sum of the gradients over
    ``group`` (``torch.distributed.nn.functional.all_reduce``, which
    torch 2.13 deprecates)."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class BatchNorm2d(nn.BatchNorm2d):
    """f32 BatchNorm that updates its running stats the way Flax does,
    followed by a ReLU where ``relu``; called with a ``residual``, it ends
    a residual block: ``relu(bn(x) + residual)`` (``relu`` then False). It
    computes in its parameters' dtype: f32, or f64 in a model cast to f64
    (on the CPU). Its output is in the input's dtype.

    Locally (no group) it runs through ``ops/kernels/batch_norm.py:
    batch_norm``: on the card the BatchNorm kernels, forward and backward;
    on the CPU their twins. With a ``group`` (``set_batchnorm_group``) of
    ``group_size`` processes along the data axis, training statistics are
    those of the global batch: two all-reduced passes (the mean, then the
    centred squares), each process holding the same number of rows."""

    group = None
    group_size = 1

    def __init__(self, num_features: int, relu: bool = False):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.relu = relu

    def extra_repr(self) -> str:
        return super().extra_repr() + (", relu=True" if self.relu else "")

    def _global_batch_norm(self, x32: torch.Tensor) -> torch.Tensor:
        count = x32.numel() // x32.shape[1] * self.group_size
        dims = (0, 2, 3)
        mean = _AllReduceSum.apply(x32.sum(dim=dims), self.group) / count
        xc = x32 - mean[None, :, None, None]
        var = _AllReduceSum.apply((xc * xc).sum(dim=dims), self.group) / count
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps)
        return (xc * (inv * self.weight)[None, :, None, None]
                + self.bias[None, :, None, None])

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.training and self.group is not None:
            y = self._global_batch_norm(x.to(self.weight.dtype)).to(x.dtype)
            return activate(y, self.relu, residual)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.num_batches_tracked,
                          self.training, self.momentum, self.eps, self.relu,
                          residual)


def set_batchnorm_group(model: nn.Module, group, size: int) -> None:
    """Normalise every ``BatchNorm2d`` of ``model`` over ``group`` (the data
    axis, ``size`` processes) in training; None keeps the local batch."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.group, m.group_size = (group, size) if size > 1 else (None, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """Transposed conv in the input's dtype; weights cast to it per call.

    Torch's ``padding=1`` with a 4x4 stride-2 kernel is Flax's
    ``ConvTranspose(4, 2, "SAME")`` with the kernel flipped in both spatial
    dims (``utils/weights.py:resnet_from_flax`` flips it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding)


class ConvBN(nn.Sequential):
    """``Sequential(conv, bn)``: the reference's naming for the stem-less
    conv+BN pairs (transitions, fuse layers, downsample). The reference's
    ``nn.ReLU`` (a third module, no parameters) is the BatchNorm's fused
    ReLU here."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 relu: bool = True, policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__(conv(cin, cout, kernel, stride, policy=policy),
                         BatchNorm2d(cout, relu=relu))


class BasicBlock(nn.Module):
    """2x 3x3 conv residual block (pose_resnet.py:29-58). expansion = 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, policy=policy)
        self.bn1 = BatchNorm2d(planes, relu=True)
        self.conv2 = conv(planes, planes, 3, policy=policy)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (ConvBN(inplanes, planes * self.expansion, 1,
                                  stride, relu=False, policy=policy)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.bn1(self.conv1(x)))
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn2(out, residual=residual)  # relu(bn2(out) + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block (pose_resnet.py:61-99). expansion=4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1, policy=policy)
        self.bn1 = BatchNorm2d(planes, relu=True)
        self.conv2 = conv(planes, planes, 3, stride, policy=policy)
        self.bn2 = BatchNorm2d(planes, relu=True)
        self.conv3 = conv(planes, planes * self.expansion, 1, policy=policy)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.downsample = (ConvBN(inplanes, planes * self.expansion, 1,
                                  stride, relu=False, policy=policy)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x))
        out = self.conv3(self.bn2(self.conv2(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return self.bn3(out, residual=residual)  # relu(bn3(out) + residual)


class BottleneckCaffe(Bottleneck):
    """Caffe-style bottleneck: the stride sits on the first 1x1 conv
    (pose_resnet.py:102-141)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__(inplanes, planes, stride, downsample, policy)
        self.conv1 = conv(inplanes, planes, 1, stride, policy=policy)
        self.conv2 = conv(planes, planes, 3, policy=policy)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel=3, stride=2, padding=1), as the JAX stem's
    ``nn.max_pool`` with ((1, 1), (1, 1)) padding."""
    return F.max_pool2d(x, 3, 2, 1)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """nn.Upsample(scale_factor=factor, mode='nearest') on NCHW
    (pose_hrnet.py:206); each pixel repeated ``factor`` times per axis."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default init, drawn from ``generator``: conv and transposed
    conv weights Uniform(+-1/sqrt(fan_in)) (kaiming_uniform with
    a=sqrt(5)), biases Uniform(+-1/sqrt(fan_in)), BatchNorm scale 1, bias
    0, stats 0/1. The reference never calls its own init
    (pose_resnet.py:319-320), so this is its effective init and the JAX
    package's ``TORCH_CONV_KERNEL_INIT``. For a transposed conv torch takes
    the fan-in from the output channels; Flax takes it from the input
    channels, which differs for SimpleBaseline's first deconv (2048 in,
    256 out)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                if m.bias is not None:
                    fan_in = m.weight[0].numel()
                    bound = 1.0 / math.sqrt(fan_in)
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
