"""A small transformer pose model in ViTPose's layout (Xu et al., NeurIPS
2022, "ViTPose: Simple Vision Transformer Baselines for Human Pose
Estimation", arXiv:2204.12484), which the benchmark's tests add as files
alone to show that a new architecture needs no edit of the harness. It is
no cell: the program has no such model.

A patch embedding (a conv of the patch's size and stride, padded by
``patch_padding``), the absolute position embedding added as
``pos_embed[:, 1:] + pos_embed[:, :1]``, pre-LN blocks (LayerNorm with
``ln_eps``; qkv with bias, scaled dot-product attention, proj; LayerNorm;
fc1, GELU, fc2), a last LayerNorm, then the classic decoder: stride-2 4x4
deconvs with BatchNorm and ReLU, and a 1x1 conv to the joint heatmaps.
Each block runs under ``torch.utils.checkpoint`` while gradients are
taken: the same arithmetic with less memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5


def grid(cfg: dict) -> int:
    """Patches along each side of the image."""
    return ((cfg["image_size"] + 2 * cfg["patch_padding"]
             - cfg["patch_size"]) // cfg["patch_size"] + 1)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg["embed_dim"], cfg["patch_size"],
                              cfg["patch_size"], cfg["patch_padding"])

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads,
                                      d // self.heads).permute(2, 0, 3, 1, 4)
        x = F.scaled_dot_product_attention(q, k, v)
        return self.proj(x.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        dim = cfg["embed_dim"]
        self.norm1 = nn.LayerNorm(dim, eps=cfg["ln_eps"])
        self.attn = Attention(dim, cfg["num_heads"])
        self.norm2 = nn.LayerNorm(dim, eps=cfg["ln_eps"])
        self.mlp = Mlp(dim, cfg["mlp_ratio"] * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PoseViT(nn.Module):
    FREE_STD = {"pos_embed": 0.02}  # ViT's truncated normal of std 0.02

    def __init__(self, cfg: dict):
        super().__init__()
        dim, n = cfg["embed_dim"], grid(cfg)
        self.grid = n
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n + 1, dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg["depth"]))
        self.last_norm = nn.LayerNorm(dim, eps=cfg["ln_eps"])
        head, cin, k = [], dim, cfg["deconv_kernel"]
        for feat in cfg["deconv_filters"]:
            head += [nn.ConvTranspose2d(cin, feat, k, stride=2,
                                        padding=(k - 2) // 2, bias=False),
                     nn.BatchNorm2d(feat, eps=BN_EPS), nn.ReLU()]
            cin = feat
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = nn.Conv2d(cin, cfg["num_joints"],
                                     cfg["final_conv_kernel"])

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, 1:] + self.pos_embed[:, :1]
        for block in self.blocks:
            x = (checkpoint(block, x, use_reentrant=False)
                 if torch.is_grad_enabled() else block(x))
        x = self.last_norm(x).transpose(1, 2).unflatten(
            2, (self.grid, self.grid))
        return self.final_layer(self.deconv_layers(x))


def build(cfg: dict, quant=None) -> nn.Module:
    if quant is not None:
        raise ValueError("the int8 policy quantizes backbone convs only; "
                         "this model has no int8 reference")
    return PoseViT(cfg)
