"""Procrustes alignment / PA-MPJPE: counterpart of
``lighthand_tpu/ops/procrustes.py``.

Reference: ``compute_similarity_transform`` + ``reconstruction_error``
(src/utils/metric_pampjpe.py:12-99, with the epsilon guard of
src/utils/loss.py:238-304), batched over samples.

The SVD is ``torch.linalg.svd`` (the JAX package's is XLA's, outside any
kernel). Both return singular values in descending order; a singular pair
whose vectors flip sign together leaves ``r = v z u^T`` and ``det(u v^T)``
unchanged, so the aligned points agree whatever signs each library picks.
"""

from __future__ import annotations

import torch


def _align(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """[..., N, D] -> s1 aligned to s2 (similarity transform), f32."""
    # work in [D, N] like the reference
    x1 = s1.float().mT
    x2 = s2.float().mT
    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    c1 = x1 - mu1
    c2 = x2 - mu2

    var1 = (c1**2).sum(dim=(-2, -1))
    k = c1 @ c2.mT
    u, _, vh = torch.linalg.svd(k)
    v = vh.mT
    z = torch.eye(u.shape[-1], dtype=torch.float32, device=u.device)
    z = z.expand(u.shape).clone()
    z[..., -1, -1] *= torch.sign(torch.linalg.det(u @ v.mT))
    r = v @ z @ u.mT

    eps = torch.finfo(torch.float32).tiny
    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1) / (var1 + eps)
    scale = scale[..., None, None]
    t = mu2 - scale * (r @ mu1)
    return (scale * r @ x1 + t).mT


def compute_similarity_transform(s1: torch.Tensor,
                                 s2: torch.Tensor) -> torch.Tensor:
    """Optimal similarity transform (scale, rotation, translation) aligning
    point set s1 to s2 via orthogonal Procrustes (SVD).

    Args: s1, s2 of shape [N, D] (points x dims, D in {2, 3}).
    Returns s1_hat [N, D] — s1 after alignment.
    """
    return _align(s1, s2)


def reconstruction_error(s1: torch.Tensor, s2: torch.Tensor,
                         reduction: str = "mean") -> torch.Tensor:
    """PA-MPJPE: align each sample then mean joint L2 error.

    Args: s1, s2 of shape [B, N, D].
    """
    s1_hat = _align(s1, s2)
    re = torch.sqrt(((s1_hat - s2.float()) ** 2).sum(dim=-1)).mean(dim=-1)
    if reduction == "mean":
        return re.mean()
    if reduction == "sum":
        return re.sum()
    return re
