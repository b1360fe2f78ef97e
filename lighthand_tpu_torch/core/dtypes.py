"""Mixed-precision policy: bf16 convolutions, f32 params, BatchNorm and logits.

Counterpart of ``lighthand_tpu/core/dtypes.py``. Parameters stay f32; each
conv runs in ``compute_dtype`` with its weights cast to it; BatchNorm is
computed in f32 and its output cast back to ``compute_dtype``; the final
logits come out in ``output_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32  # final heatmap logits / loss

    @classmethod
    def full_precision(cls) -> "DTypePolicy":
        return cls(compute_dtype=torch.float32)


DEFAULT_POLICY = DTypePolicy()
