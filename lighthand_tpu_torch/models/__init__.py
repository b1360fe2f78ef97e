"""Model registry: counterpart of ``lighthand_tpu/models/__init__.py``."""

from __future__ import annotations

import dataclasses

from torch import nn

from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from lighthand_tpu_torch.models.hrnet import HRNetCfg, PoseHRNet
from lighthand_tpu_torch.models.resnet import PoseResNet


def get_model(name: str, num_joints: int = 21,
              policy: DTypePolicy = DEFAULT_POLICY) -> nn.Module:
    """'simplebaseline' (= resnet50), 'resnet{18,34,50,101,152}', 'hrnet'
    (= hrnet_w48, the reference cfg.yaml), 'hrnet_w32', 'hrnet_w48',
    'hrnet_tiny' (test topology), 'hrnet_wN'."""
    name = name.lower()
    if name in ("simplebaseline", "resnet", "resnet50"):
        return PoseResNet(num_layers=50, num_joints=num_joints, policy=policy)
    if name.startswith("resnet"):
        return PoseResNet(num_layers=int(name[len("resnet"):]),
                          num_joints=num_joints, policy=policy)
    if name in ("hrnet", "hrnet_w48"):
        cfg = HRNetCfg.w48()
    elif name == "hrnet_w32":
        cfg = HRNetCfg.w32()
    elif name == "hrnet_tiny":
        cfg = HRNetCfg.tiny()
    elif name.startswith("hrnet_w"):
        cfg = HRNetCfg.from_width(int(name[len("hrnet_w"):]))
    else:
        raise ValueError(
            f"unknown model {name!r}; expected simplebaseline|resnetN|"
            "hrnet[_wN]")
    return PoseHRNet(cfg=dataclasses.replace(cfg, num_joints=num_joints),
                     policy=policy)


__all__ = ["get_model", "PoseHRNet", "PoseResNet", "HRNetCfg"]
