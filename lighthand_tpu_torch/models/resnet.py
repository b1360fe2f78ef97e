"""SimpleBaseline (PoseResNet) in PyTorch, numerically the JAX package's.

Counterpart of ``lighthand_tpu/models/resnet.py`` (reference
``pose_resnet.py:144-322``): ResNet-{18,34,50,101,152}, then 3x
(ConvTranspose 4x4 stride 2, 256 channels, BN, ReLU), then a 1x1 conv to
the joint heatmaps. Submodules carry the reference's ``state_dict`` names
(``conv1``, ``bn1``, ``layer{n}.{i}.conv1``, ``deconv_layers.{0,1,3,4,6,7}``,
``final_layer``), which ``lighthand_tpu/utils/torch_port.py:
pose_resnet_from_torch`` consumes.

Layout: NCHW in and out; on the card the caller keeps tensors in
``channels_last`` memory. The input is cast to the policy's compute dtype,
the logits ``[B, J, H/4, W/4]`` come out in its output dtype (f32).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from lighthand_tpu_torch.models.layers import (
    BasicBlock,
    BatchNorm2d,
    Bottleneck,
    BottleneckCaffe,
    ConvTranspose2d,
    conv,
    max_pool_3x3_s2,
    quant_convs,
    quantized_weights,
)

# resnet_spec (pose_resnet.py:301-305)
RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class PoseResNet(nn.Module):
    """SimpleBaseline pose net; defaults are the reference config's
    (NUM_LAYERS 50, 3 deconv layers of 256 filters, FINAL_CONV_KERNEL 1,
    21 joints)."""

    def __init__(self, num_layers: int = 50, num_joints: int = 21,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 final_conv_kernel: int = 1, caffe_style: bool = False,
                 policy: DTypePolicy = DEFAULT_POLICY):
        super().__init__()
        block, layers = RESNET_SPEC[num_layers]
        if caffe_style:
            block = BottleneckCaffe
        self.policy = policy
        # Stem: 7x7 s2 conv + BN + ReLU + 3x3 s2 max-pool
        self.conv1 = conv(3, 64, 7, 2, policy=policy)
        self.bn1 = BatchNorm2d(64, relu=True)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            out = planes * block.expansion
            seq = [block(inplanes, planes, stride,
                         stride != 1 or inplanes != out, policy)]
            seq += [block(out, planes, policy=policy)
                    for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
            inplanes = out
        # Deconv head: Sequential [deconv, BN, ReLU] x3 (pose_resnet.py:
        # 207-232); the ReLU is the BatchNorm's, an Identity keeps its index
        head = []
        for feat in deconv_filters:
            head += [ConvTranspose2d(inplanes, feat, 4, stride=2, padding=1,
                                     bias=False),
                     BatchNorm2d(feat, relu=True), nn.Identity()]
            inplanes = feat
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = conv(inplanes, num_joints, final_conv_kernel,
                                bias=True)
        self.quant_convs = quant_convs(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under int8_fwd, every QuantConv2d weight quantized in one call
        with quantized_weights(self.quant_convs):
            x = x.to(self.policy.compute_dtype)
            x = max_pool_3x3_s2(self.bn1(self.conv1(x)))
            x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
            x = self.deconv_layers(x)
            return self.final_layer(x).to(self.policy.output_dtype)
