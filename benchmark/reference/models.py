"""Plain float32 pose models: the benchmark's reference for HRNet and
SimpleBaseline.

They follow the published networks (Sun et al., CVPR 2019, "Deep
High-Resolution Representation Learning for Human Pose Estimation"; Xiao
et al., ECCV 2018, "Simple Baselines for Human Pose Estimation and
Tracking") as LightHand's PyTorch code lays them out (``pose_hrnet.py``,
``pose_resnet.py``): convs padded by k//2 and without bias, except the
final 1x1; BatchNorm with eps 1e-5 after every conv and deconv; HRNet's
SUM fuse with nearest upsampling. Submodules carry that code's state-dict
names, so the benchmark hands one set of seeded weights to the program
under test and to these models by name. Nothing here imports the program.

``build(config)`` reads the sizes from a configuration file's dict.
``quant_bits`` runs every backbone conv (those LightHand's int8 policy
quantizes: stems, block convs, downsamples, transitions and fuse layers;
not the deconvs and not the final conv) on fake-quantized operands:
per-output-channel symmetric weights, per-tensor symmetric activations
clipped at ``act_clip``. It is the control of a cell whose stated
precision is int8.

Any other architecture is a file of its own, ``reference/<architecture>.py``,
found by the configuration's ``architecture`` (``lhbench.spec.architecture``)
and added without an edit here. Its ``build(cfg, quant)`` returns the plain
f32 model, whose state-dict names are the program's; it may refuse a
``quant`` other than None, since the int8 policy covers backbone convs
only. Such a model may compute each block under ``torch.utils.checkpoint``:
the same arithmetic, recomputed in the backward, with less memory, so that
a large model's f32 reference fits on the card beside the program's state.
A parameter that is neither a conv's, a deconv's nor a linear layer's
weight (a position embedding, a class token) is named with its standard
deviation in the model's ``FREE_STD`` dict, from which
``lhbench.inputs.weights`` draws it.

``forward_flops`` counts the FLOPs of one image's forward through any of
these models.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

BN_EPS = 1e-5


def fake_quant(x: torch.Tensor, bits: int, clip: torch.Tensor | float
               ) -> torch.Tensor:
    """``x`` rounded to a symmetric grid of ``2**(bits-1) - 1`` steps each
    side of 0 over ``clip`` (a number, or a tensor that broadcasts)."""
    q = 2 ** (bits - 1) - 1
    scale = clip / q
    return torch.clamp(torch.round(x / scale), -q, q) * scale


class Conv(nn.Conv2d):
    """A conv padded by k//2; with ``quant`` = (bits, act_clip) its
    operands are fake-quantized first."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 bias: bool = False, quant=None):
        super().__init__(cin, cout, kernel, stride, kernel // 2, bias=bias)
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return super().forward(x)
        bits, clip = self.quant
        amax = self.weight.abs().amax(dim=(1, 2, 3), keepdim=True)
        w = fake_quant(self.weight, bits, torch.clamp_min(amax, 1e-8))
        return F.conv2d(fake_quant(x, bits, clip), w, None, self.stride,
                        self.padding)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1,
            relu: bool = True, quant=None) -> nn.Sequential:
    layers = [Conv(cin, cout, kernel, stride, quant=quant), bn(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, quant=None):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, quant=quant)
        self.bn1 = bn(planes)
        self.conv2 = Conv(planes, planes, 3, quant=quant)
        self.bn2 = bn(planes)
        self.downsample = (conv_bn(cin, planes, 1, stride, False, quant)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, quant=None):
        super().__init__()
        self.conv1 = Conv(cin, planes, 1, quant=quant)
        self.bn1 = bn(planes)
        self.conv2 = Conv(planes, planes, 3, stride, quant=quant)
        self.bn2 = bn(planes)
        self.conv3 = Conv(planes, planes * 4, 1, quant=quant)
        self.bn3 = bn(planes * 4)
        self.downsample = (conv_bn(cin, planes * 4, 1, stride, False, quant)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HRModule(nn.Module):
    """Parallel branches, then every branch's output summed into each
    output resolution (finer to coarser by stride-2 3x3 convs, coarser to
    finer by a 1x1 conv and nearest upsampling), then ReLU."""

    def __init__(self, block, blocks: int, cin: List[int],
                 widths: Sequence[int], outputs: int, quant=None):
        super().__init__()
        exp = block.expansion
        self.branches = nn.ModuleList()
        for i, planes in enumerate(widths):
            seq = [block(cin[i], planes, 1, cin[i] != planes * exp, quant)]
            seq += [block(planes * exp, planes, quant=quant)
                    for _ in range(1, blocks)]
            self.branches.append(nn.Sequential(*seq))
        chans = [w * exp for w in widths]
        self.out_channels = chans
        self.fuse_layers = nn.ModuleList()
        for i in range(outputs):
            row = []
            for j in range(len(widths)):
                if j == i:
                    row.append(None)
                elif j > i:
                    row.append(conv_bn(chans[j], chans[i], 1, relu=False,
                                       quant=quant))
                else:
                    row.append(nn.Sequential(*[
                        conv_bn(chans[j], chans[i] if k == i - j - 1
                                else chans[j], 3, 2, relu=k != i - j - 1,
                                quant=quant)
                        for k in range(i - j)]))
            self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs):
        ys = [b(x) for b, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = ys[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                t = layer(ys[j])
                if j > i:
                    t = F.interpolate(t, scale_factor=2 ** (j - i),
                                      mode="nearest")
                acc = acc + t
            outs.append(F.relu(acc))
        return outs


class HRNet(nn.Module):
    """Stem (two stride-2 3x3 convs), layer1 (4 bottlenecks of 64), then
    stages of 2, 3 and 4 branches; the final 1x1 conv reads the finest
    branch."""

    def __init__(self, cfg: dict, quant=None):
        super().__init__()
        widths = list(cfg["widths"])
        block = BLOCKS[cfg["block"]]
        blocks = cfg["blocks_per_branch"]
        stem = cfg["stem_width"]
        self.conv1 = Conv(3, stem, 3, 2, quant=quant)
        self.bn1 = bn(stem)
        self.conv2 = Conv(stem, stem, 3, 2, quant=quant)
        self.bn2 = bn(stem)
        self.layer1 = nn.Sequential(
            Bottleneck(stem, 64, 1, True, quant),
            *[Bottleneck(256, 64, quant=quant)
              for _ in range(cfg["layer1_blocks"] - 1)])
        prev = [256]
        for s, modules in enumerate(cfg["stage_modules"]):
            n = s + 2
            stage_widths = widths[:n]
            chans = [w * block.expansion for w in stage_widths]
            setattr(self, f"transition{s + 1}",
                    self._transition(prev, chans, quant))
            mods, cin = [], chans
            for m in range(modules):
                last = s == len(cfg["stage_modules"]) - 1 and m == modules - 1
                mod = HRModule(block, blocks, cin, stage_widths,
                               1 if last else n, quant)
                cin = mod.out_channels
                mods.append(mod)
            setattr(self, f"stage{n}", nn.Sequential(*mods))
            prev = cin
        self.stages = len(cfg["stage_modules"])
        self.final_layer = Conv(prev[0], cfg["num_joints"],
                                cfg["final_conv_kernel"], bias=True)

    @staticmethod
    def _transition(prev: List[int], chans: List[int], quant):
        layers = []
        for i, c in enumerate(chans):
            if i < len(prev):
                layers.append(None if prev[i] == c
                              else conv_bn(prev[i], c, 3, 1, quant=quant))
            else:
                hops = i + 1 - len(prev)
                layers.append(nn.Sequential(*[
                    conv_bn(prev[-1], c if k == hops - 1 else prev[-1], 3, 2,
                            quant=quant) for k in range(hops)]))
        return nn.ModuleList(layers)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s in range(self.stages):
            trans = getattr(self, f"transition{s + 1}")
            xs = [xs[i] if t is None else t(xs[min(i, len(xs) - 1)])
                  for i, t in enumerate(trans)]
            xs = getattr(self, f"stage{s + 2}")(xs)
        return self.final_layer(xs[0])


RESNET_BLOCKS = {50: (Bottleneck, (3, 4, 6, 3)),
                 101: (Bottleneck, (3, 4, 23, 3)),
                 152: (Bottleneck, (3, 8, 36, 3)),
                 18: (BasicBlock, (2, 2, 2, 2)),
                 34: (BasicBlock, (3, 4, 6, 3))}


class SimpleBaseline(nn.Module):
    """ResNet (7x7 stride-2 stem, 3x3 stride-2 max-pool, four stages), then
    stride-2 4x4 deconvs with BN and ReLU, then a 1x1 conv to the joint
    heatmaps."""

    def __init__(self, cfg: dict, quant=None):
        super().__init__()
        block, layers = RESNET_BLOCKS[cfg["num_layers"]]
        self.conv1 = Conv(3, 64, 7, 2, quant=quant)
        self.bn1 = bn(64)
        cin = 64
        for s, (planes, n, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            out = planes * block.expansion
            seq = [block(cin, planes, stride, stride != 1 or cin != out,
                         quant)]
            seq += [block(out, planes, quant=quant) for _ in range(1, n)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*seq))
            cin = out
        head = []
        k = cfg["deconv_kernel"]
        for feat in cfg["deconv_filters"]:
            head += [nn.ConvTranspose2d(cin, feat, k, stride=2,
                                        padding=(k - 2) // 2, bias=False),
                     bn(feat), nn.ReLU()]
            cin = feat
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = Conv(cin, cfg["num_joints"],
                                cfg["final_conv_kernel"], bias=True)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.final_layer(self.deconv_layers(x))


ARCHITECTURES = {"hrnet": HRNet, "simplebaseline": SimpleBaseline}


def build(cfg: dict, quant_bits: int | None = None,
          act_clip: float = 8.0) -> nn.Module:
    """The reference model of a configuration dict (its ``architecture``
    and sizes), f32, on the CPU; ``quant_bits`` fake-quantizes the
    backbone convs. An architecture not held here is built by its own
    file, ``reference/<architecture>.py``."""
    quant = None if quant_bits is None else (quant_bits, act_clip)
    arch = cfg["architecture"]
    if arch in ARCHITECTURES:
        return ARCHITECTURES[arch](cfg, quant)
    from lhbench import spec

    return spec.architecture(arch).build(cfg, quant)


def forward_flops(model: nn.Module, image_size: int) -> int:
    """FLOPs of one image's forward on ``model``'s own device (on the meta
    device nothing is computed), 2 a multiply-accumulate of every conv,
    deconv, linear layer and attention product, as torch's
    ``FlopCounterMode`` counts them from the shapes. Attention takes SDPA's
    math path, whose two products the counter sees on every device (the
    CPU's fused SDPA counts none)."""
    device = next(model.parameters()).device
    with (torch.no_grad(), sdpa_kernel(SDPBackend.MATH),
          FlopCounterMode(display=False) as counter):
        model(torch.zeros(1, 3, image_size, image_size, device=device))
    return counter.get_total_flops()
