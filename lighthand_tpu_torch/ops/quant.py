"""int8 quantized convolution (forward) with a straight-through backward.

Counterpart of ``lighthand_tpu/ops/quant.py``, the conv of the
``int8_fwd`` policy (``DTypePolicy.quant_fwd``):

- weights: per-output-channel symmetric quantization, the scales derived
  from the f32 master weights on every forward, as the JAX package does
  (nothing is cached across forwards): the CUDA kernel
  ``quantize_weights_cuda``, one launch for all the convs of a model's
  forward (``quantize_group``; the JAX package has no such call, XLA fuses
  each conv's quantize on its own: the same function in fewer launches),
  or a group of one for a conv called on its own;
- activations: per-tensor symmetric quantization with the static clip
  ``act_clip`` (8.0), inside the conv kernel's load;
- the s8 x s8 -> s32 conv and its dequantizing epilogue: the CUDA kernel
  ``int8_conv2d_cuda``;
- backward: the straight-through estimator, exactly the vjp of the plain
  conv in ``compute_dtype`` at ``(x, w)`` (dx in x's dtype, dw in w's).

On the card a model's int8 forward is one launch of the weight kernel, then
one launch of the conv kernel a conv (``ops/kernels/int8_conv.py``); on the
CPU both wrappers compute their plain twins, which follow JAX's formulas
bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from lighthand_tpu_torch.ops.kernels.int8_conv import (
    int8_conv2d_cuda,
    quantize_weight_cuda,
    quantize_weights_cuda,
)

Quantized = Tuple[torch.Tensor, torch.Tensor]  # (w_q, scale) of one conv


def quantize_group(weights: Sequence[torch.Tensor],
                   act_clip: float) -> List[Quantized]:
    """(``w_q``, ``scale``) of each f32 master weight, all in one grouped
    call (one launch on the card), outside autograd: the straight-through
    backward differentiates the float conv at ``w``, not ``w_q``."""
    with torch.no_grad():
        return [(w_q, scale) for w_q, _, scale in
                quantize_weights_cuda(weights, act_clip)]


def quant_forward(x: torch.Tensor, w: torch.Tensor, stride: int,
                  padding: int, act_clip: float, out_dtype: torch.dtype,
                  quantized: Quantized | None = None) -> torch.Tensor:
    """The quantized conv: ``x`` NCHW bf16 or f32 activations
    (``channels_last`` on the card), ``w`` the f32 master weights ``[Cout,
    Cin, kh, kw]``, ``quantized`` their (``w_q``, ``scale``) where a grouped
    call made them already (else ``w`` is quantized here, a group of one);
    the result in ``out_dtype``."""
    if quantized is None:
        w_q, _, scale = quantize_weight_cuda(w, act_clip)
    else:
        w_q, scale = quantized
    if x.device.type == "cuda":  # a no-op for the models' activations
        x = x.contiguous(memory_format=torch.channels_last)
    return int8_conv2d_cuda(x, w_q, scale, act_clip, stride, padding,
                            out_dtype)


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, act_clip, compute_dtype,
                quantized):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, compute_dtype)
        return quant_forward(x, w, stride, padding, act_clip, compute_dtype,
                             quantized)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, compute_dtype = ctx.conv
        if not any(ctx.needs_input_grad[:2]):
            return (None,) * 7
        with torch.enable_grad():
            xd, wd = x.detach(), w.detach()
            inputs = [t.requires_grad_() for t, need in
                      zip((xd, wd), ctx.needs_input_grad[:2]) if need]
            y = F.conv2d(xd.to(compute_dtype), wd.to(compute_dtype), None,
                         stride, padding)
            grads = iter(torch.autograd.grad(y, inputs, g.to(compute_dtype)))
        dx = next(grads) if ctx.needs_input_grad[0] else None
        dw = next(grads) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None, None, None


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
              act_clip: float, compute_dtype: torch.dtype,
              quantized: Quantized | None = None) -> torch.Tensor:
    """Quantized-forward conv, STE backward.

    x: NCHW bf16 or f32 activations; w: f32 master weights ``[Cout,
    Cin, kh, kw]``; stride and padding the same on both axes; act_clip the
    static symmetric activation clip; compute_dtype the dtype of the output
    and of the backward convs (the policy's compute_dtype); quantized:
    ``w``'s (``w_q``, ``scale``) from ``quantize_group``, or None to
    quantize ``w`` here. Where no gradient is wanted (eval, serving), the
    forward runs without the autograd Function, whose set-up costs host
    time a call."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return quant_forward(x, w, stride, padding, act_clip, compute_dtype,
                             quantized)
    return _Int8Conv.apply(x, w, stride, padding, act_clip, compute_dtype,
                           quantized)
