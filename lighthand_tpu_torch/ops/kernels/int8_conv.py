"""The int8_fwd policy's quantized convolution as two CUDA kernels
(``csrc/int8_conv.cu``), with their plain twins:

- ``quantize_weights_cuda``: the f32 master weights of a list of convs to
  s8 per output channel, their scales and the dequantizing scales, one
  launch for the list (``quantize_weight_cuda``: a list of one);
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
import struct
from typing import List, Sequence, Tuple

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


def quantize_weights_plain(ws: Sequence[torch.Tensor], act_clip: float):
    """The grouped weight kernel's function: ``quantize_weight_plain`` of
    each weight."""
    return [quantize_weight_plain(w, act_clip) for w in ws]


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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lh_int8_conv.argtypes = [p, i, f, p, p, p, i] + [i] * 11 + [p]
    lib.lh_int8_conv.restype = i
    lib.lh_int8_conv_plan.argtypes = [p, i, p] + [i] * 12 + [p]
    lib.lh_int8_conv_plan.restype = i
    lib.lh_quantize_weights.argtypes = [p, i, i, i, f, p, p, i, p]
    lib.lh_quantize_weights.restype = i
    return lib


# The grouped weight kernel's table (csrc/int8_conv.cu): a QConv row a
# conv (the weight's pointer and strides, w_q's byte offset in the s8 pool,
# Cout, Cin, kh, kw, s_w's offset in the f32 pool, channels an item, mode,
# flat), then from the next multiple of 16 bytes an int32 pair (conv, first
# channel) an item.
QCONV = struct.Struct("<q4qq8i")
Q_MAX_CH = 64             # channels an item (kQMaxCh)
Q_ITEM_BYTES = 16384      # f32 bytes an item, at most
Q_MAX_STAGE = 96 * 1024   # bytes a stage buffer (kQMaxStage)
Q_BULK, Q_LOAD, Q_GLOBAL = 0, 1, 2  # how an item's rows reach the block
Q_ALIGN = 128             # w_q's offsets in the s8 pool, in bytes


def _row_dense(shape, stride) -> bool:
    """Whether each output channel's Cin * kh * kw values are one dense
    span (in some order of the three axes)."""
    want = 1
    for st, n in sorted((st, n) for st, n in zip(stride[1:], shape[1:])
                        if n > 1):
        if st != want:
            return False
        want *= n
    return True


def _row_flat(shape, stride) -> bool:
    """Whether each output channel's values lie in w_q's [kh, kw, Cin]
    order (channels_last, or a 1x1 conv)."""
    _, cin, kh, kw = shape
    _, s1, s2, s3 = stride
    return ((cin == 1 or s1 == 1) and (kw == 1 or s3 == cin)
            and (kh == 1 or s2 == kw * cin))


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def quantize_plan(weights: Sequence[Tuple[int, tuple, tuple]],
                  sms: int = 132) -> dict:
    """The grouped weight kernel's work for ``weights``, a list of (data
    pointer, shape ``[Cout, Cin, kh, kw]``, element strides) of f32
    tensors, on a card of ``sms`` SMs:

    - ``table``: the bytes of the kernel's table (``QCONV`` rows, then the
      items), ``n_convs`` and ``n_items``;
    - ``stage``: the bytes a stage buffer (the largest staged item);
    - ``wq_views``: each w_q's (shape, stride, byte offset) in the s8 pool
      of ``wq_bytes`` (offsets multiples of 128, so that each w_q starts
      as a fresh allocation's 16-byte TMA and vector loads want);
    - ``couts``: each weight's channels, whose s_w lie one after the other
      in the first ``n_sw`` values of the f32 pool, their scales in the
      next ``n_sw``.

    A row's mode says how a conv's rows reach a block: ``Q_BULK``, a TMA
    bulk copy; ``Q_LOAD``, the block's own loads, for dense rows the copy
    cannot take; ``Q_GLOBAL``, read in place, for other strides or rows
    larger than a stage buffer.

    Items hold up to ``Q_ITEM_BYTES`` of f32 (less for a small group, so
    that every SM gets work), one channel where a row alone is larger, and
    a conv's items even channel counts."""
    total = sum(4 * s[0] * s[1] * s[2] * s[3] for _, s, _ in weights)
    item_bytes = min(Q_ITEM_BYTES, max(1024, total // (8 * sms)))
    rows, items, views = [], [], []
    wq_bytes = n_sw = stage = 0
    for i, (ptr, shape, stride) in enumerate(weights):
        cout, cin, kh, kw = shape
        k = cin * kh * kw
        row = 4 * k
        dense = _row_dense(shape, stride)
        if not dense or row > Q_MAX_STAGE:
            mode = Q_GLOBAL
        elif ptr % 16 == 0 and 4 * stride[0] % 16 == 0 and row % 16 == 0:
            mode = Q_BULK
        elif stride[0] == k or cout == 1:
            mode = Q_LOAD
        else:
            mode = Q_GLOBAL
        # channels an item: the fewest items of at most item_bytes (or one
        # row), the conv's channels spread evenly over them
        cpi = max(1, min(Q_MAX_CH, item_bytes // row))
        cpi = -(-cout // -(-cout // cpi)) if cout else 1
        flat = mode != Q_GLOBAL and k % 16 == 0 and _row_flat(shape, stride)
        if mode != Q_GLOBAL:
            stage = max(stage, min(cpi, cout) * row)
        views.append(((cout, kh, kw, cin), (k, kw * cin, cin, 1), wq_bytes))
        rows.append(QCONV.pack(ptr, *stride, wq_bytes, cout, cin, kh, kw,
                               n_sw, cpi, mode, int(flat)))
        items.extend((i, c) for c in range(0, cout, cpi))
        wq_bytes += _align(cout * k, Q_ALIGN)
        n_sw += cout
    head = b"".join(rows)
    table = (head + bytes(_align(len(head), 16) - len(head))
             + struct.pack(f"<{2 * len(items)}i",
                           *[v for item in items for v in item]))
    return {"table": table, "n_convs": len(weights), "n_items": len(items),
            "stage": _align(stage, 16), "wq_views": views,
            "wq_bytes": wq_bytes, "n_sw": n_sw,
            "couts": [s[0] for _, s, _ in weights]}


def _check(entries) -> None:
    """ValueError unless ``entries``, the (dtype, device, shape) of each
    weight of a group, are f32 ``[Cout, Cin, kh, kw]`` with input values,
    all on one device."""
    if not entries:
        raise ValueError("no weights to quantize")
    device = entries[0][1]
    for dtype, dev, shape in entries:
        if len(shape) != 4 or dtype != torch.float32:
            raise ValueError(f"w must be f32 [Cout, Cin, kh, kw], got "
                             f"{dtype} {tuple(shape)}")
        if dev != device:
            raise ValueError(f"weights on devices {device} and {dev}: a "
                             "group lies on one device")
        if shape[1] * shape[2] * shape[3] == 0:
            raise ValueError(f"w has no input values: {tuple(shape)}")


@functools.lru_cache(maxsize=512)
def _device_plan(key: tuple) -> tuple:
    """(the plan of a group of weights on the card, its table there), from
    the (data pointer, dtype, device index, shape, strides) of each weight,
    checked and built once: a repeated forward copies nothing to the card
    and can be captured in a CUDA graph; new pointers (after a ``.to()``,
    FSDP2's all-gather buffers) make a new table."""
    _check([k[1:4] for k in key])
    index = key[0][2]
    plan = quantize_plan([(k[0], tuple(k[3]), k[4]) for k in key],
                         _sm_count(index))
    table = torch.frombuffer(bytearray(plan["table"]), dtype=torch.uint8)
    return plan, table.to(torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def quantize_weights_cuda(ws: Sequence[torch.Tensor], act_clip: float
                          ) -> List[tuple]:
    """One (``w_q`` s8 ``[Cout, kh, kw, Cin]`` contiguous, ``s_w`` f32
    ``[Cout]``, ``scale`` f32 ``[Cout]``) for each f32 master weight ``w``
    ``[Cout, Cin, kh, kw]`` of ``ws``, in any layout, all on one device.

    On the card this is one launch of the grouped kernel (or raises), its
    results views of one s8 and one f32 pool allocated here, each w_q at a
    128-byte offset; on the CPU it computes the plain twin of each weight.
    ``quantize_weights_cuda.launches`` counts the kernel launches."""
    if not act_clip > 0:
        raise ValueError(f"act_clip must be positive, got {act_clip}")
    if not ws or not ws[0].is_cuda:
        _check([(w.dtype, w.device, w.shape) for w in ws])
        if ws[0].device.type != "cpu":
            raise ValueError(f"unsupported device {ws[0].device}")
        return quantize_weights_plain(ws, act_clip)
    plan, table = _device_plan(tuple(
        (w.data_ptr(), w.dtype, w.get_device(), w.shape, w.stride())
        for w in ws))
    device = ws[0].device
    pool = torch.empty(plan["wq_bytes"], dtype=torch.int8, device=device)
    fpool = torch.empty(2 * plan["n_sw"], dtype=torch.float32,
                        device=device)
    ctx, stream = _launch_on(device)
    with ctx:
        err = _lib().lh_quantize_weights(
            table.data_ptr(), plan["n_convs"], plan["n_items"],
            plan["stage"], act_scale(act_clip), pool.data_ptr(),
            fpool.data_ptr(), plan["n_sw"], stream)
        quantize_weights_cuda.launches += 1
    if err:
        raise RuntimeError(f"weight quantize kernel launch failed: CUDA "
                           f"error {err}")
    return pool_views(plan, pool, fpool)


def pool_views(plan: dict, pool: torch.Tensor,
               fpool: torch.Tensor) -> List[tuple]:
    """(``w_q`` ``[Cout, kh, kw, Cin]``, ``s_w``, ``scale``) of each weight
    of ``plan``: views of the s8 ``pool`` and the f32 ``fpool`` at its
    offsets (made in few host calls: a forward makes one a weight)."""
    n_sw = plan["n_sw"]
    w_q = [pool.as_strided(*v) for v in plan["wq_views"]]
    s_w = fpool[:n_sw].split_with_sizes(plan["couts"])
    scale = fpool[n_sw:].split_with_sizes(plan["couts"])
    return list(zip(w_q, s_w, scale))


quantize_weights_cuda.launches = 0


def quantize_weight_cuda(w: torch.Tensor, act_clip: float):
    """(``w_q`` s8 ``[Cout, kh, kw, Cin]`` contiguous, ``s_w`` f32
    ``[Cout]``, ``scale`` f32 ``[Cout]``) from f32 master weights ``w``
    ``[Cout, Cin, kh, kw]`` in any layout: ``quantize_weights_cuda`` of a
    group of one (one launch on the card, counted there; the twin on the
    CPU)."""
    return quantize_weights_cuda([w], act_clip)[0]


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


PATHS = ("simple", "wgmma", "stem")  # csrc/int8_conv.cu's Path, in order


def conv_plan(x: torch.Tensor, w_q: torch.Tensor, stride: int,
              padding: int, out_dtype: torch.dtype = torch.bfloat16) -> dict:
    """How ``int8_conv2d_cuda(x, w_q, ...)`` runs on the card: the path
    ("wgmma", the halo tiles and TMA-fed wgmma for Cin a multiple of 32;
    "stem", halo tiles quantized as they are read, for Cin not a multiple
    of 32 with kh * kw * Cin <= 256; or "simple", mma.sync with gathered
    loads, for the rest) and, for the first two, the channels a block
    (``bn``), the tile's width in pixels (``tw``) and the shared memory a
    block (``smem``), with the wgmma path's channels a chunk (``ck``) or
    the stem path's K rounded up to 32 (``k_pad``)."""
    n, cin, h, w = x.shape
    cout, kh, kw, _ = w_q.shape
    ho, wo = out_size(h, kh, stride, padding), out_size(w, kw, stride,
                                                         padding)
    got = (ctypes.c_int * 5)()
    _lib().lh_int8_conv_plan(
        x.data_ptr(), int(x.dtype == torch.float32), w_q.data_ptr(),
        int(out_dtype == torch.float32), n, h, w, cin, cout, kh, kw, stride,
        padding, ho, wo, got)
    bn, ck, tw, smem, path = list(got)
    if PATHS[path] == "simple":
        return {"path": "simple"}
    return {"path": PATHS[path], "bn": bn,
            ("ck" if PATHS[path] == "wgmma" else "k_pad"): ck, "tw": tw,
            "smem": smem}
