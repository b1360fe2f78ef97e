"""Mixed-precision policy: bf16 convolutions, f32 params, BatchNorm and logits.

Counterpart of ``lighthand_tpu/core/dtypes.py``. Parameters stay f32; each
conv runs in ``compute_dtype`` with its weights cast to it; BatchNorm is
computed in f32 and its output cast back to ``compute_dtype``; the final
logits come out in ``output_dtype``.

``bn_dtype`` is kept for the policy's name and fields, and changes no
number: the JAX package's ``nn.BatchNorm(dtype=bn_dtype)`` keeps Flax's
``force_float32_reductions=True``, so it computes its statistics and its
normalisation in f32 and casts only the result to ``bn_dtype``, which the
block then casts to ``compute_dtype`` (bf16 either way). ``all_bf16`` is
therefore numerically the default policy in both packages, and the port's
``BatchNorm2d`` (f32 inside, output in the input's dtype) serves both.

``quant_fwd`` runs every backbone conv (the JAX package's ``ConvBN``) as
an int8 forward with a straight-through backward (``ops/quant.py``); the
deconv head and the final 1x1 stay in ``compute_dtype``.

f32 (``full_precision``) means full f32 on the card too, as the JAX
package computes on the CPU and as the tests hold the port: torch's cuDNN
convolutions default to TF32 (10-bit mantissas), so the entry points run
an f32 policy inside ``numerics(policy)``, which turns TF32 off for convs
and matmuls and restores both switches on exit. The other policies compute
their convs in bf16, which TF32 does not touch, and leave the switches as
they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32  # final heatmap logits / loss
    bn_dtype: torch.dtype = torch.float32
    quant_fwd: bool = False
    act_clip: float = 8.0  # symmetric activation clip for quant_fwd

    @classmethod
    def full_precision(cls) -> "DTypePolicy":
        return cls(compute_dtype=torch.float32)

    @classmethod
    def all_bf16(cls) -> "DTypePolicy":
        return cls(bn_dtype=torch.bfloat16)

    @classmethod
    def int8_fwd(cls) -> "DTypePolicy":
        return cls(quant_fwd=True)


DEFAULT_POLICY = DTypePolicy()


@contextlib.contextmanager
def numerics(policy: DTypePolicy) -> Iterator[None]:
    """Run ``policy``'s f32 math as full f32: for an f32 ``compute_dtype``,
    ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` are False inside and restored
    on exit; any other policy changes neither."""
    if policy.compute_dtype != torch.float32:
        yield
        return
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
