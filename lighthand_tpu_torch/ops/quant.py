"""int8 quantized convolution (forward) with a straight-through backward.

Counterpart of ``lighthand_tpu/ops/quant.py``, the conv of the
``int8_fwd`` policy (``DTypePolicy.quant_fwd``):

- weights: per-output-channel symmetric quantization, the scales derived
  from the f32 master weights on every call, as the JAX package does
  (nothing is cached);
- activations: per-tensor symmetric quantization with the static clip
  ``act_clip`` (8.0);
- the s8 x s8 -> s32 conv and its dequantizing epilogue: the CUDA kernel
  ``ops/kernels/int8_conv.py`` on the card, its plain twin on the CPU;
- backward: the straight-through estimator, exactly the vjp of the plain
  conv in ``compute_dtype`` at ``(x, w)`` (dx in x's dtype, dw in w's).

The quantize steps are plain PyTorch, as XLA computes them outside any
Pallas kernel in the JAX package. Each scalar enters the arithmetic as the
f32 value JAX's weakly typed Python scalar becomes, so the results are
JAX's bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lighthand_tpu_torch.ops.kernels.int8_conv import int8_conv2d_cuda


def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def quantize_weight(w: torch.Tensor):
    """f32 master weights ``[Cout, Cin, kh, kw]`` -> (s8 ``[Cout, kh, kw,
    Cin]`` contiguous, f32 per-channel scale ``s_w`` ``[Cout]``)."""
    w32 = w.float()
    s_w = torch.clamp_min(w32.abs().amax(dim=(1, 2, 3)), _f32(1e-8)) / 127.0
    w_q = torch.clamp(torch.round(w32 / s_w[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s_w


def quantize_activation(x: torch.Tensor, act_clip: float) -> torch.Tensor:
    """Per-tensor s8 with the static clip: round(x * (127 / act_clip)),
    clamped to +-127; ``channels_last`` on the card, as the kernel reads."""
    inv = _f32(1.0 / (act_clip / 127.0))
    x_q = torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)
    if x_q.device.type == "cuda":
        x_q = x_q.contiguous(memory_format=torch.channels_last)
    return x_q


def quant_forward(x: torch.Tensor, w: torch.Tensor, stride: int,
                  padding: int, act_clip: float,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The quantized conv: ``x`` NCHW activations, ``w`` the f32 master
    weights ``[Cout, Cin, kh, kw]``; the result in ``out_dtype``."""
    w_q, s_w = quantize_weight(w)
    x_q = quantize_activation(x, act_clip)
    scale = s_w * _f32(act_clip / 127.0)
    return int8_conv2d_cuda(x_q, w_q, scale, stride, padding, out_dtype)


class _Int8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, act_clip, compute_dtype):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, compute_dtype)
        return quant_forward(x, w, stride, padding, act_clip, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, compute_dtype = ctx.conv
        if not any(ctx.needs_input_grad[:2]):
            return (None,) * 6
        with torch.enable_grad():
            xd, wd = x.detach(), w.detach()
            inputs = [t.requires_grad_() for t, need in
                      zip((xd, wd), ctx.needs_input_grad[:2]) if need]
            y = F.conv2d(xd.to(compute_dtype), wd.to(compute_dtype), None,
                         stride, padding)
            grads = iter(torch.autograd.grad(y, inputs, g.to(compute_dtype)))
        dx = next(grads) if ctx.needs_input_grad[0] else None
        dw = next(grads) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None, None


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
              act_clip: float, compute_dtype: torch.dtype) -> torch.Tensor:
    """Quantized-forward conv, STE backward.

    x: NCHW activations (any float dtype); w: f32 master weights ``[Cout,
    Cin, kh, kw]``; stride and padding the same on both axes; act_clip the
    static symmetric activation clip; compute_dtype the dtype of the output
    and of the backward convs (the policy's compute_dtype)."""
    return _Int8Conv.apply(x, w, stride, padding, act_clip, compute_dtype)
