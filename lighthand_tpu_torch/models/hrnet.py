"""HRNet (PoseHighResolutionNet) in PyTorch, numerically the JAX package's.

Counterpart of ``lighthand_tpu/models/hrnet.py`` (topology from the
reference ``pose_hrnet.py:274-501`` and ``cfg.yaml:52-90``). Submodules
carry the reference's ``state_dict`` names (``conv1``, ``layer1.0.conv1``,
``transition1.1.0.0``, ``stage2.0.branches.0.0.conv1``,
``stage2.0.fuse_layers.1.0.0.0``, ``final_layer``), which are the keys
``lighthand_tpu/utils/torch_port.py:pose_hrnet_from_torch`` consumes.

Layout: NCHW tensors in and out; on the card the caller keeps them in
``channels_last`` memory. The input is cast to the policy's compute dtype,
the logits ``[B, J, H/4, W/4]`` come out in its output dtype (f32).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from lighthand_tpu_torch.models.layers import (
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    ConvBN,
    conv,
    nearest_upsample,
    quant_convs,
    quantized_weights,
)


@dataclasses.dataclass(frozen=True)
class HRNetStageCfg:
    num_modules: int
    num_branches: int
    num_blocks: Tuple[int, ...]
    num_channels: Tuple[int, ...]
    block: str = "BASIC"  # BASIC | BOTTLENECK
    fuse_method: str = "SUM"


@dataclasses.dataclass(frozen=True)
class HRNetCfg:
    """Topology description; defaults = W48 (cfg.yaml:52-90)."""

    num_joints: int = 21
    final_conv_kernel: int = 1
    stage2: HRNetStageCfg = HRNetStageCfg(1, 2, (4, 4), (48, 96))
    stage3: HRNetStageCfg = HRNetStageCfg(4, 3, (4, 4, 4), (48, 96, 192))
    stage4: HRNetStageCfg = HRNetStageCfg(3, 4, (4, 4, 4, 4),
                                          (48, 96, 192, 384))

    @classmethod
    def w48(cls) -> "HRNetCfg":
        return cls()

    @classmethod
    def w32(cls) -> "HRNetCfg":
        return cls.from_width(32)

    @classmethod
    def tiny(cls) -> "HRNetCfg":
        """Every code path of the full net (4 stages, 2/3/4 branches, all
        fuse directions incl. multi-hop strided chains, both kinds of
        transition) at 1 module per stage, 1 block per branch, width 8."""
        return cls(
            stage2=HRNetStageCfg(1, 2, (1, 1), (8, 16)),
            stage3=HRNetStageCfg(1, 3, (1, 1, 1), (8, 16, 32)),
            stage4=HRNetStageCfg(1, 4, (1, 1, 1, 1), (8, 16, 32, 64)),
        )

    @classmethod
    def from_width(cls, width: int) -> "HRNetCfg":
        return cls(
            stage2=HRNetStageCfg(1, 2, (4, 4), (width, width * 2)),
            stage3=HRNetStageCfg(4, 3, (4, 4, 4),
                                 (width, width * 2, width * 4)),
            stage4=HRNetStageCfg(3, 4, (4, 4, 4, 4),
                                 (width, width * 2, width * 4, width * 8)),
        )


_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


class HighResolutionModule(nn.Module):
    """Parallel branches + full cross-resolution SUM fuse
    (pose_hrnet.py:101-265)."""

    def __init__(self, cfg: HRNetStageCfg, in_channels: List[int],
                 multi_scale_output: bool,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        block = _BLOCKS[cfg.block]
        exp = block.expansion
        self.branches = nn.ModuleList()
        for i in range(cfg.num_branches):
            planes = cfg.num_channels[i]
            blocks = [block(in_channels[i], planes, 1,
                            in_channels[i] != planes * exp, policy)]
            blocks += [block(planes * exp, planes, policy=policy)
                       for _ in range(1, cfg.num_blocks[i])]
            self.branches.append(nn.Sequential(*blocks))
        self.out_channels = [c * exp for c in cfg.num_channels]

        n_out = cfg.num_branches if multi_scale_output else 1
        chans = self.out_channels
        self.fuse_layers = nn.ModuleList()
        for i in range(n_out):
            row = []
            for j in range(cfg.num_branches):
                if j == i:
                    row.append(None)
                elif j > i:
                    # coarser -> finer: 1x1 conv + BN, then nearest 2^(j-i)
                    row.append(ConvBN(chans[j], chans[i], 1, relu=False,
                                      policy=policy))
                else:
                    # finer -> coarser: (i-j) stride-2 3x3 hops; the
                    # intermediate hops keep C_j and ReLU, the last -> C_i
                    hops = [ConvBN(chans[j], chans[i] if k == i - j - 1
                                   else chans[j], 3, 2,
                                   relu=k != i - j - 1, policy=policy)
                            for k in range(i - j)]
                    row.append(nn.Sequential(*hops))
            self.fuse_layers.append(nn.ModuleList(row))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, row in enumerate(self.fuse_layers):
            acc = ys[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                t = layer(ys[j])
                if j > i:
                    t = nearest_upsample(t, 2 ** (j - i))
                acc = acc + t
            outs.append(torch.relu(acc))
        return outs


class PoseHRNet(nn.Module):
    """Full network (pose_hrnet.py:274-460)."""

    def __init__(self, cfg: HRNetCfg = HRNetCfg.w48(),
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        # Stem: 2x 3x3 s2 conv (pose_hrnet.py:282-288) -> 1/4 resolution
        self.conv1 = conv(3, 64, 3, 2, policy=policy)
        self.bn1 = BatchNorm2d(64, relu=True)
        self.conv2 = conv(64, 64, 3, 2, policy=policy)
        self.bn2 = BatchNorm2d(64, relu=True)
        # layer1: 4x Bottleneck(64) -> 256 channels (pose_hrnet.py:289)
        self.layer1 = nn.Sequential(
            Bottleneck(64, 64, 1, True, policy),
            *[Bottleneck(256, 64, policy=policy) for _ in range(3)])

        self.transition1 = self._make_transition([256], cfg.stage2, policy)
        self.stage2, chans = self._make_stage(
            cfg.stage2, self._widths(cfg.stage2), True, policy)
        self.transition2 = self._make_transition(chans, cfg.stage3, policy)
        self.stage3, chans = self._make_stage(
            cfg.stage3, self._widths(cfg.stage3), True, policy)
        self.transition3 = self._make_transition(chans, cfg.stage4, policy)
        self.stage4, chans = self._make_stage(
            cfg.stage4, self._widths(cfg.stage4), False, policy)

        # final 1x1 conv on the highest-resolution branch (pose_hrnet.py:323)
        self.final_layer = conv(chans[0], cfg.num_joints,
                                cfg.final_conv_kernel, bias=True)
        self.quant_convs = quant_convs(self)

    @staticmethod
    def _widths(cfg: HRNetStageCfg) -> List[int]:
        exp = _BLOCKS[cfg.block].expansion
        return [c * exp for c in cfg.num_channels]

    @staticmethod
    def _make_stage(cfg: HRNetStageCfg, in_channels: List[int],
                    multi_scale_output: bool, policy: DTypePolicy):
        modules = []
        for m in range(cfg.num_modules):
            mso = multi_scale_output or m != cfg.num_modules - 1
            mod = HighResolutionModule(cfg, in_channels, mso, policy)
            in_channels = mod.out_channels
            modules.append(mod)
        return nn.Sequential(*modules), in_channels

    @staticmethod
    def _make_transition(prev: List[int], cur: HRNetStageCfg,
                         policy: DTypePolicy) -> nn.ModuleList:
        """pose_hrnet.py:333-372: identity (None) on branches of matching
        width, conv+BN+ReLU on a width change, and each new branch a chain
        of stride-2 3x3 convs from the last previous branch."""
        widths = PoseHRNet._widths(cur)
        layers = []
        for i, c in enumerate(widths):
            if i < len(prev):
                layers.append(None if prev[i] == c
                              else ConvBN(prev[i], c, 3, 1, policy=policy))
            else:
                hops = i + 1 - len(prev)
                layers.append(nn.Sequential(*[
                    ConvBN(prev[-1], c if k == hops - 1 else prev[-1], 3, 2,
                           policy=policy)
                    for k in range(hops)]))
        return nn.ModuleList(layers)

    @staticmethod
    def _transition(layers: nn.ModuleList, xs: List[torch.Tensor]):
        return [xs[i] if layer is None else layer(xs[min(i, len(xs) - 1)])
                for i, layer in enumerate(layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under int8_fwd, every QuantConv2d weight quantized in one call
        with quantized_weights(self.quant_convs):
            x = x.to(self.policy.compute_dtype)
            x = self.bn1(self.conv1(x))
            x = self.bn2(self.conv2(x))
            x = self.layer1(x)
            xs = self.stage2(self._transition(self.transition1, [x]))
            xs = self.stage3(self._transition(self.transition2, xs))
            xs = self.stage4(self._transition(self.transition3, xs))
            return self.final_layer(xs[0]).to(self.policy.output_dtype)
