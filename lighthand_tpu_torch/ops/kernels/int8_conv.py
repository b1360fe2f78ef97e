"""The int8_fwd policy's quantized convolution as two CUDA kernels
(``csrc/int8_conv.cu``), with their plain twins:

- ``quantize_weight_cuda``: the f32 master weights to s8 per output channel,
  their scales and the dequantizing scales, one launch;
- ``int8_conv2d_cuda``: the conv on float activations, which the kernel
  quantizes at the static clip as it loads them, with the dequantizing
  epilogue.

Replaces no Pallas kernel: the JAX package leaves the quantize and its s8 x
s8 -> s32 conv to XLA (``lighthand_tpu/ops/quant.py:43-59``), and PyTorch
has no int8 convolution on CUDA. The kernels' note says what bounds them on
the card and what their design does about it.

Every scalar enters the arithmetic as the f32 value JAX's weakly typed
Python scalar becomes, and every division divides (on a CUDA tensor,
PyTorch turns a Python-scalar divisor into a reciprocal multiply), so the
twins are JAX's formulas bit for bit on either device.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from lighthand_tpu_torch.ops.color import divide
from lighthand_tpu_torch.ops.kernels._build import library

IN_DTYPES = OUT_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def _f32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def act_inv(act_clip: float) -> float:
    """The activations' multiplier, f32(1 / (act_clip / 127)), as JAX's
    ``x * (1.0 / s_x)`` computes it."""
    return _f32(1.0 / (act_clip / 127.0))


def act_scale(act_clip: float) -> float:
    """s_x = f32(act_clip / 127), the factor of the dequantizing scale."""
    return _f32(act_clip / 127.0)


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


# ------------------------------------------------------------- the twins


def quantize_weight(w: torch.Tensor):
    """f32 master weights ``[Cout, Cin, kh, kw]`` -> (s8 ``[Cout, kh, kw,
    Cin]`` contiguous, f32 per-channel ``s_w`` ``[Cout]``): JAX's
    ``max(amax |w|, 1e-8) / 127`` and ``clip(round(w / s_w), -127, 127)``,
    both true divisions."""
    w32 = w.float()
    m = torch.clamp_min(w32.abs().amax(dim=(1, 2, 3)), _f32(1e-8))
    s_w = divide(m, 127.0)
    w_q = torch.clamp(torch.round(w32 / s_w[:, None, None, None]), -127, 127)
    return w_q.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s_w


def quantize_activation(x: torch.Tensor, act_clip: float) -> torch.Tensor:
    """Per-tensor s8 with the static clip: round(x * (127 / act_clip)) in
    f32, clamped to +-127, in ``x``'s layout."""
    x_q = torch.clamp(torch.round(x.float() * act_inv(act_clip)), -127, 127)
    return x_q.to(torch.int8)


def quantize_weight_plain(w: torch.Tensor, act_clip: float):
    """The weight kernel's function: (``w_q`` s8 ``[Cout, kh, kw, Cin]``,
    ``s_w`` f32 ``[Cout]``, ``scale`` = s_w * f32(act_clip / 127))."""
    w_q, s_w = quantize_weight(w)
    return w_q, s_w, s_w * act_scale(act_clip)


def int8_conv2d_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor, act_clip: float, stride: int,
                      padding: int,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The conv kernel's function: ``quantize_activation``, then the conv
    in float64 on the integer values (exact: every partial sum is an
    integer below 2^53), then the epilogue: f32 with round-to-nearest-even,
    times the f32 per-channel ``scale``, rounded to ``out_dtype``.

    On the card a float64 conv may go to a cuDNN algorithm that is not
    exact (FFT, Winograd); compute this with cuDNN off there."""
    x_q = quantize_activation(x, act_clip)
    y = F.conv2d(x_q.double(), w_q.permute(0, 3, 1, 2).double(), None,
                 stride, padding)
    return (y.float() * scale[:, None, None]).to(out_dtype)


# ------------------------------------------------------------ the kernels


def _launch_on(device: torch.device):
    """(context that makes ``device`` current, its current stream as an
    int). A quantized conv is two launches of these kernels, as many as a
    bf16 conv's, so their wrappers keep their host work small: no device
    switch where ``device`` is current already, and the raw stream handle
    (``torch.cuda.current_stream()`` builds a Stream object each call)."""
    ctx = (contextlib.nullcontext() if device.index ==
           torch.cuda.current_device() else torch.cuda.device(device))
    return ctx, torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("int8_conv")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    lib.lh_int8_conv.argtypes = [p, i, f, p, p, p, i] + [i] * 11 + [p]
    lib.lh_int8_conv.restype = i
    lib.lh_int8_conv_plan.argtypes = [p, i, p] + [i] * 12 + [p]
    lib.lh_int8_conv_plan.restype = i
    lib.lh_quantize_weight.argtypes = [p, ll, ll, ll, ll, i, i, i, i, f, p, p,
                                       p, p]
    lib.lh_quantize_weight.restype = i
    return lib


def quantize_weight_cuda(w: torch.Tensor, act_clip: float):
    """(``w_q`` s8 ``[Cout, kh, kw, Cin]`` contiguous, ``s_w`` f32
    ``[Cout]``, ``scale`` f32 ``[Cout]``) from f32 master weights ``w``
    ``[Cout, Cin, kh, kw]`` in any layout (``channels_last`` reads
    contiguously).

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it computes the plain twin. ``quantize_weight_cuda.launches`` counts
    the kernel launches."""
    if w.ndim != 4 or w.dtype != torch.float32:
        raise ValueError(f"w must be f32 [Cout, Cin, kh, kw], got {w.dtype} "
                         f"{tuple(w.shape)}")
    if not act_clip > 0:
        raise ValueError(f"act_clip must be positive, got {act_clip}")
    if w.device.type == "cpu":
        return quantize_weight_plain(w, act_clip)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    cout, cin, kh, kw = w.shape
    w_q = torch.empty((cout, kh, kw, cin), dtype=torch.int8, device=w.device)
    s_w, scale = torch.empty((2, cout), dtype=torch.float32, device=w.device)
    ctx, stream = _launch_on(w.device)
    with ctx:
        err = _lib().lh_quantize_weight(
            w.data_ptr(), *w.stride(), cout, cin, kh, kw,
            act_scale(act_clip), w_q.data_ptr(), s_w.data_ptr(),
            scale.data_ptr(), stream)
        quantize_weight_cuda.launches += 1
    if err:
        raise RuntimeError(f"weight quantize kernel launch failed: CUDA "
                           f"error {err}")
    return w_q, s_w, scale


quantize_weight_cuda.launches = 0


def _check_conv(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                act_clip: float, stride: int, padding: int,
                out_dtype: torch.dtype):
    if x.ndim != 4 or w_q.ndim != 4:
        raise ValueError(f"x must be [N, Cin, H, W] and w_q [Cout, kh, kw, "
                         f"Cin], got {tuple(x.shape)} and {tuple(w_q.shape)}")
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    n, cin, h, w = x.shape
    cout, kh, kw, wcin = w_q.shape
    if wcin != cin:
        raise ValueError(f"w_q has {wcin} input channels, x {cin}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (cout,):
        raise ValueError(f"scale must be f32 [{cout}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    if not act_clip > 0:
        raise ValueError(f"act_clip must be positive, got {act_clip}")
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride {stride} or padding {padding}")
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride,
                                                         padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"window {kh}x{kw} does not fit {h}x{w} at padding "
                         f"{padding}")
    return ho, wo


def int8_conv2d_cuda(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor, act_clip: float, stride: int,
                     padding: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Quantized conv with a dequantizing epilogue.

    ``x``: bf16 or f32 ``[N, Cin, H, W]``, in ``channels_last`` memory on
    the card, quantized at ``act_clip`` inside the kernel; ``w_q``: s8
    ``[Cout, kh, kw, Cin]``, contiguous; ``scale``: f32 ``[Cout]``;
    ``stride`` and ``padding`` the same on both axes. Returns ``[N, Cout,
    Ho, Wo]`` in ``out_dtype`` (bf16 or f32), ``channels_last`` on the card.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it computes the plain twin. ``int8_conv2d_cuda.launches`` counts the
    kernel launches."""
    ho, wo = _check_conv(x, w_q, scale, act_clip, stride, padding, out_dtype)
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, w_q, scale, act_clip, stride, padding,
                                 out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if w_q.device != x.device or scale.device != x.device:
        raise ValueError("x, w_q and scale must be on one device")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be in channels_last memory")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w_q and scale must be contiguous")

    n, cin, h, w = x.shape
    cout, kh, kw, _ = w_q.shape
    out = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last)
    ctx, stream = _launch_on(x.device)
    with ctx:
        err = _lib().lh_int8_conv(
            x.data_ptr(), int(x.dtype == torch.float32), act_inv(act_clip),
            w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), n, h, w, cin, cout, kh, kw,
            stride, padding, ho, wo, stream)
        int8_conv2d_cuda.launches += 1
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    return out


int8_conv2d_cuda.launches = 0


def conv_plan(x: torch.Tensor, w_q: torch.Tensor, stride: int,
              padding: int, out_dtype: torch.dtype = torch.bfloat16) -> dict:
    """How ``int8_conv2d_cuda(x, w_q, ...)`` runs on the card: the path
    ("wgmma", the halo tiles and TMA-fed wgmma, or "simple", mma.sync with
    gathered loads) and, for the wgmma path, the channels a block (``bn``),
    the channels a chunk (``ck``), the tile's width in pixels (``tw``) and
    the shared memory a block (``smem``)."""
    n, cin, h, w = x.shape
    cout, kh, kw, _ = w_q.shape
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride,
                                                         padding)
    got = (ctypes.c_int * 4)()
    _lib().lh_int8_conv_plan(
        x.data_ptr(), int(x.dtype == torch.float32), w_q.data_ptr(),
        int(out_dtype == torch.float32), n, h, w, cin, cout, kh, kw, stride,
        padding, ho, wo, got)
    bn, ck, tw, smem = list(got)
    if not bn:
        return {"path": "simple"}
    return {"path": "wgmma", "bn": bn, "ck": ck, "tw": tw, "smem": smem}
