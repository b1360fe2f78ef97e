"""The int8 convolution of the ``int8_fwd`` policy as a CUDA kernel
(``csrc/int8_conv.cu``), with its plain twin.

Replaces no Pallas kernel: the JAX package leaves its s8 x s8 -> s32 conv
to XLA (``lighthand_tpu/ops/quant.py:54``), and PyTorch has no int8
convolution on CUDA. The kernel's note says what bounds it on the card and
what its design does about it. The quantize steps around it are plain
PyTorch, in ``ops/quant.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lighthand_tpu_torch.ops.kernels._build import library

OUT_DTYPES = (torch.bfloat16, torch.float32)


def out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def int8_conv2d_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor, stride: int, padding: int,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the conv in float64 on the
    integer values (exact: every partial sum is an integer below 2^53),
    then the kernel's epilogue: f32 with round-to-nearest-even, times the
    f32 per-channel ``scale``, rounded to ``out_dtype``.

    On the card a float64 conv may go to a cuDNN algorithm that is not
    exact (FFT, Winograd); compute this on CPU copies there."""
    y = F.conv2d(x_q.double(), w_q.permute(0, 3, 1, 2).double(), None,
                 stride, padding)
    return (y.float() * scale[:, None, None]).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("int8_conv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lh_int8_conv.argtypes = [p, p, p, p, i] + [i] * 11 + [p]
    lib.lh_int8_conv.restype = ctypes.c_int
    return lib


def int8_conv2d_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor, stride: int, padding: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 conv with a dequantising epilogue.

    ``x_q``: s8 ``[N, Cin, H, W]``, in ``channels_last`` memory on the card;
    ``w_q``: s8 ``[Cout, kh, kw, Cin]``, contiguous; ``scale``: f32
    ``[Cout]``; ``stride`` and ``padding`` the same on both axes. Returns
    ``[N, Cout, Ho, Wo]`` in ``out_dtype`` (bf16 or f32), ``channels_last``
    on the card.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it computes the plain twin. ``int8_conv2d_cuda.launches`` counts the
    kernel launches."""
    if x_q.ndim != 4 or w_q.ndim != 4:
        raise ValueError(f"x_q must be [N, Cin, H, W] and w_q [Cout, kh, kw, "
                         f"Cin], got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    n, cin, h, w = x_q.shape
    cout, kh, kw, wcin = w_q.shape
    if wcin != cin:
        raise ValueError(f"w_q has {wcin} input channels, x_q {cin}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (cout,):
        raise ValueError(f"scale must be f32 [{cout}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got "
                         f"{out_dtype}")
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride {stride} or padding {padding}")
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride,
                                                         padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"window {kh}x{kw} does not fit {h}x{w} at padding "
                         f"{padding}")
    if x_q.device.type == "cpu":
        return int8_conv2d_plain(x_q, w_q, scale, stride, padding, out_dtype)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    if w_q.device != x_q.device or scale.device != x_q.device:
        raise ValueError("x_q, w_q and scale must be on one device")
    if not x_q.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x_q must be in channels_last memory")
    if not (w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("w_q and scale must be contiguous")

    out = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=x_q.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x_q.device):
        err = _lib().lh_int8_conv(
            x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), n, h, w, cin, cout, kh, kw,
            stride, padding, ho, wo, torch.cuda.current_stream().cuda_stream)
        int8_conv2d_cuda.launches += 1
    if err:
        raise RuntimeError(f"int8 conv kernel launch failed: CUDA error {err}")
    return out


int8_conv2d_cuda.launches = 0
