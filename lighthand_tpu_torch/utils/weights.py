"""JAX-package weights -> the port's ``state_dict``.

The inverse of ``lighthand_tpu/utils/torch_port.py:pose_hrnet_from_torch``
and ``pose_resnet_from_torch``: it turns the JAX package's ``{"params",
"batch_stats"}`` tree (numpy leaves) into the port's (= the reference's)
HRNet or PoseResNet ``state_dict``.

- Flax conv kernel ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``;
- Flax transposed-conv kernel ``[kh, kw, I, O]`` -> torch ``[I, O, kh, kw]``
  with both spatial dims flipped: Flax's ``ConvTranspose`` correlates with
  the kernel as stored, torch's is the gradient of a conv, i.e. correlation
  with the flipped kernel;
- BatchNorm ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
  running_var`` (plus ``num_batches_tracked`` = 0).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.models.resnet import RESNET_SPEC

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.array(v, dtype=np.float32)
    return out


class _FlaxToTorch:
    def __init__(self, variables: Mapping):
        self.params = _flatten(variables["params"])
        self.stats = _flatten(variables.get("batch_stats", {}))
        self.sd: Dict[str, torch.Tensor] = {}

    def take(self, tree: Dict[Path, np.ndarray], path: Path) -> torch.Tensor:
        try:
            return torch.from_numpy(tree.pop(path))
        except KeyError:
            raise KeyError(f"flax tree has no entry {'/'.join(path)!r}") \
                from None

    def has(self, path: Path) -> bool:
        return path + ("Conv_0", "kernel") in self.params

    def conv_bn(self, fpath: Path, tconv: str, tbn: str) -> None:
        kernel = self.take(self.params, fpath + ("Conv_0", "kernel"))
        self.sd[f"{tconv}.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
        self.bn(fpath + ("BatchNorm_0",), tbn)

    def bn(self, p: Path, tbn: str) -> None:
        self.sd[f"{tbn}.weight"] = self.take(self.params, p + ("scale",))
        self.sd[f"{tbn}.bias"] = self.take(self.params, p + ("bias",))
        self.sd[f"{tbn}.running_mean"] = self.take(self.stats, p + ("mean",))
        self.sd[f"{tbn}.running_var"] = self.take(self.stats, p + ("var",))
        self.sd[f"{tbn}.num_batches_tracked"] = torch.tensor(0)

    def residual_block(self, fpath: Path, tprefix: str, n_convs: int) -> None:
        for n in range(1, n_convs + 1):
            self.conv_bn(fpath + (f"ConvBN_{n - 1}",), f"{tprefix}.conv{n}",
                         f"{tprefix}.bn{n}")
        down = fpath + (f"ConvBN_{n_convs}",)
        if self.has(down):
            self.conv_bn(down, f"{tprefix}.downsample.0",
                         f"{tprefix}.downsample.1")

    def final_layer(self) -> None:
        kernel = self.take(self.params, ("final_layer", "kernel"))
        self.sd["final_layer.weight"] = kernel.permute(3, 2, 0, 1).contiguous()
        self.sd["final_layer.bias"] = self.take(self.params,
                                                ("final_layer", "bias"))

    def finish(self) -> Dict[str, torch.Tensor]:
        leftovers = ["/".join(k) for k in (*self.params, *self.stats)]
        if leftovers:
            raise ValueError(f"unconsumed flax entries: {leftovers[:8]}")
        return self.sd


def hrnet_from_flax(variables: Mapping,
                    cfg: HRNetCfg | None = None) -> Dict[str, torch.Tensor]:
    """JAX ``PoseHRNet`` variables -> the port's ``PoseHRNet`` state_dict."""
    cfg = cfg or HRNetCfg.w32()
    b = _FlaxToTorch(variables)

    b.conv_bn(("stem1",), "conv1", "bn1")
    b.conv_bn(("stem2",), "conv2", "bn2")
    for i in range(4):
        b.residual_block((f"layer1_block{i}",), f"layer1.{i}", 3)
    b.conv_bn(("transition1_b0",), "transition1.0.0", "transition1.0.1")
    b.conv_bn(("transition1_b1",), "transition1.1.0.0", "transition1.1.0.1")

    stages = {"stage2": cfg.stage2, "stage3": cfg.stage3,
              "stage4": cfg.stage4}
    for sname, scfg in stages.items():
        n_convs = 3 if scfg.block == "BOTTLENECK" else 2
        for m in range(scfg.num_modules):
            mpath = (f"{sname}_module{m}",)
            tmod = f"{sname}.{m}"
            for i in range(scfg.num_branches):
                for blk in range(scfg.num_blocks[i]):
                    b.residual_block(mpath + (f"branch{i}_block{blk}",),
                                     f"{tmod}.branches.{i}.{blk}", n_convs)
            last = m == scfg.num_modules - 1
            n_out = 1 if (sname == "stage4" and last) else scfg.num_branches
            for i in range(n_out):
                for j in range(scfg.num_branches):
                    if j > i:
                        b.conv_bn(mpath + (f"fuse{i}_{j}",),
                                  f"{tmod}.fuse_layers.{i}.{j}.0",
                                  f"{tmod}.fuse_layers.{i}.{j}.1")
                    for k in range(i - j):
                        b.conv_bn(mpath + (f"fuse{i}_{j}_k{k}",),
                                  f"{tmod}.fuse_layers.{i}.{j}.{k}.0",
                                  f"{tmod}.fuse_layers.{i}.{j}.{k}.1")

    # transition2/3: a width change on an existing branch, or the one new
    # branch as a single stride-2 hop from the last previous branch
    for t, scfg in (("transition2", cfg.stage3), ("transition3", cfg.stage4)):
        new = scfg.num_branches - 1
        for i in range(new):
            if b.has((f"{t}_b{i}",)):
                b.conv_bn((f"{t}_b{i}",), f"{t}.{i}.0", f"{t}.{i}.1")
        b.conv_bn((f"{t}_b{new}_k0",), f"{t}.{new}.0.0", f"{t}.{new}.0.1")

    b.final_layer()
    return b.finish()


def resnet_from_flax(variables: Mapping,
                     num_layers: int = 50) -> Dict[str, torch.Tensor]:
    """JAX ``PoseResNet`` variables -> the port's ``PoseResNet`` state_dict
    (either bottleneck style: both have three convs per block)."""
    b = _FlaxToTorch(variables)
    block, layers = RESNET_SPEC[num_layers]
    n_convs = 3 if block.expansion == 4 else 2

    b.conv_bn(("stem",), "conv1", "bn1")
    for stage, blocks in enumerate(layers):
        for i in range(blocks):
            b.residual_block((f"layer{stage + 1}_block{i}",),
                             f"layer{stage + 1}.{i}", n_convs)
    # deconv head: Sequential [deconv, BN, ReLU] x3 -> indices 0, 3, 6
    for k in range(3):
        kernel = b.take(b.params, (f"deconv{k}", "ConvTranspose_0", "kernel"))
        b.sd[f"deconv_layers.{3 * k}.weight"] = (
            kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous())
        b.bn((f"deconv{k}", "BatchNorm_0"), f"deconv_layers.{3 * k + 1}")
    b.final_layer()
    return b.finish()
