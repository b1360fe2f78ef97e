"""BatchNorm (+ an optional fused ReLU, or the end of a residual block) as
CUDA kernels (``csrc/batch_norm.cu``), with their plain twins and the
autograd Function that ``models/layers.py:BatchNorm2d`` runs through.

- ``batch_norm_train_cuda``: the training forward (statistics, the running
  statistics' update, the normalisation) in three launches;
- ``batch_norm_eval_cuda``: the eval forward from the running statistics,
  one launch;
- ``batch_norm_backward_cuda``: the backward of either, three launches.

Replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA. The
kernels' note says what bounds them on the card and what their design does
about it.

Numerics: activations in and out in the compute dtype (bf16, or f32 under
the f32 policy); parameters, statistics and every intermediate in f32; the
output rounded once; the ReLU, where fused, applied before that rounding,
which gives the bits of ``relu(bf16(y))`` since rounding is monotone; the
running variance updated with the biased batch variance, as Flax's is.
With a ``residual`` r the apply stage ends the residual block in the same
pass: ``relu(T(T(bn(x)) + r))`` in the compute dtype T, the two roundings
of the chain BN, add, ReLU, so the bits are that chain's; its backward
gates the gradient by the saved output (``threshold_backward``'s
``dy * [o > 0]``) and writes the residual's gradient, that gated ``dy``.
The twins, which the wrappers compute for a CPU tensor, are the port's
formulas before these kernels: ``var_mean`` then ``F.batch_norm`` on the
f32 copy, cast back, then ``relu`` (with a residual: the add, then
``relu``); their backward is autograd's through the same chain. On a CUDA
tensor the wrappers launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from lighthand_tpu_torch.ops.kernels._build import library

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
THREADS = 256  # a block of the partials and apply stages
# the stages' codes for lh_bn_occupancy and lh_bn_rows
FW_PARTIALS, FW_APPLY, FW_EVAL, BW_PARTIALS, BW_APPLY = range(5)


# ------------------------------------------------------------- the twins


def _act(relu: bool, residual) -> int:
    """The kernels' ``act``: the BatchNorm's own ReLU, which a residual
    block's end does not take (its ReLU follows the add)."""
    if relu and residual is not None:
        raise ValueError("with a residual the ReLU follows the add: relu "
                         "must be False")
    return int(relu)


def activate(y, relu: bool, residual=None):
    """The output of a BatchNorm ``y`` (in the compute dtype): ``relu(y +
    residual)`` with a residual (the end of a residual block, whose ReLU
    follows the add; ``relu`` must then be False), else ``y`` through a
    ReLU where ``relu``."""
    if residual is None:
        return F.relu(y) if relu else y
    _act(relu, residual)  # refuses a ReLU before the add
    return F.relu(y + residual)


def batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                           num_batches_tracked, momentum: float, eps: float,
                           relu: bool, residual=None):
    """(y, mean, invstd): the training forward in the parameters' dtype,
    the running statistics lerped toward the batch's biased ones; ``y``
    through ``activate``."""
    x32 = x.to(weight.dtype)
    with torch.no_grad():
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        running_mean.lerp_(mean, momentum)
        running_var.lerp_(var, momentum)
        num_batches_tracked.add_(1)
    y = F.batch_norm(x32, None, None, weight, bias, True, 0.0, eps)
    y = y.to(x.dtype)
    return activate(y, relu, residual), mean, torch.rsqrt(var + eps)


def batch_norm_eval_plain(x, weight, bias, running_mean, running_var,
                          eps: float, relu: bool, residual=None):
    y = F.batch_norm(x.to(weight.dtype), running_mean, running_var, weight,
                     bias, False, 0.0, eps).to(x.dtype)
    return activate(y, relu, residual)


def batch_norm_backward_plain(dy, x, weight, bias, running_mean, running_var,
                              training: bool, eps: float, relu: bool,
                              out=None):
    """(dx, dw, db): autograd's gradient of the twin's forward (in training
    the batch statistics are recomputed from ``x``, as ``F.batch_norm``'s
    own backward takes them). With ``out``, the saved output of a residual
    block's end, (dx, dw, db, dr): ``dy`` through the ReLU's backward
    (``threshold_backward`` on ``out``), which is also the residual's
    gradient ``dr``, then the BatchNorm's."""
    if out is not None:
        _act(relu, out)  # refuses a ReLU before the add
        dy = torch.ops.aten.threshold_backward(dy, out, 0)
        return batch_norm_backward_plain(dy, x, weight, bias, running_mean,
                                         running_var, training, eps,
                                         False) + (dy,)
    with torch.enable_grad():
        xd, wd, bd = (t.detach().requires_grad_() for t in (x, weight, bias))
        if training:
            y = F.batch_norm(xd.to(wd.dtype), None, None, wd, bd, True, 0.0,
                             eps)
        else:
            y = F.batch_norm(xd.to(wd.dtype), running_mean, running_var, wd,
                             bd, False, 0.0, eps)
        y = y.to(x.dtype)
        if relu:
            y = F.relu(y)
        return torch.autograd.grad(y, (xd, wd, bd), dy)


# ------------------------------------------------------------- the plan


def block_shape(channels: int, vec: int) -> Tuple[int, int]:
    """(threads along C, threads along the rows) of a block: a thread a
    ``vec`` channels of a row; the whole row where it takes at most 64
    threads, else tiles of 32 (512 bytes of bf16 a warp's row)."""
    cv = channels // vec
    tc = cv if cv <= 64 else 32
    return tc, THREADS // tc


def plan(rows: int, channels: int, vec: int, sms: int, per_sm: int,
         per_thread: int) -> Tuple[int, int, int, int]:
    """(tc, tr, splits, chunk): blocks of (tc, tr) threads over tiles of
    channels by ``splits`` runs of ``chunk`` rows. As many blocks as the
    card holds at once (``sms`` x ``per_sm``, its occupancy for the
    stage), so one wave covers the tensor; no more splits than give each
    thread the ``per_thread`` rows it loads at once, unless that leaves
    SMs without a block: then down to a row a thread."""
    tc, tr = block_shape(channels, vec)
    tiles = -(-(channels // vec) // tc)
    fill = min(-(-sms // tiles), -(-rows // tr))  # a block an SM
    target = min(sms * max(per_sm, 1) // tiles,
                 -(-rows // (tr * per_thread)))
    chunk = -(-rows // max(target, fill, 1))
    if -(-rows // chunk) < fill:  # rounded below a block an SM
        chunk = rows // fill
    return tc, tr, -(-rows // chunk), chunk


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = library("batch_norm")
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    lib.lh_bn_occupancy.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.lh_bn_rows.argtypes = [i]
    lib.lh_bn_forward_train.argtypes = [p, p, p, ll, i, i, i, i, i, i, ll,
                                        i, ll, p, p, p, p, p, f, f, i, p, p,
                                        p, p]
    lib.lh_bn_forward_eval.argtypes = [p, p, p, ll, i, i, i, i, i, i, ll, p,
                                       p, p, p, f, i, p]
    lib.lh_bn_backward.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i, ll,
                                   i, ll, p, p, p, p, i, f, i, p, p, p, p, p]
    for fn in (lib.lh_bn_occupancy, lib.lh_bn_rows, lib.lh_bn_forward_train,
               lib.lh_bn_forward_eval, lib.lh_bn_backward):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _per_sm(index: int, stage: int, dtype: int, vec: int, tc: int,
            tr: int) -> int:
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _lib().lh_bn_occupancy(stage, dtype, vec, tc, tr,
                                     ctypes.byref(blocks))
    if err:
        raise RuntimeError(f"batch norm occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


@functools.lru_cache(maxsize=4096)
def _stage_plan(index: int, stage: int, dtype: int, vec: int, rows: int,
                channels: int) -> Tuple[int, int, int, int]:
    lanes = (8 if dtype == DTYPES[torch.bfloat16] else 4) if vec else 1
    tc, tr = block_shape(channels, lanes)
    return plan(rows, channels, lanes, _sm_count(index),
                _per_sm(index, stage, dtype, vec, tc, tr),
                _lib().lh_bn_rows(stage))


# ------------------------------------------------------------- wrappers


def _layout(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x`` checked and in ``channels_last`` memory (a no-op for the
    models' activations on the card)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"parameters must be f32, got {weight.dtype}")
    return x.contiguous(memory_format=torch.channels_last)


def _vec(*tensors) -> int:
    """1 where each row of every tensor (None: none) splits into 16-byte
    vectors."""
    t = tensors[0]
    return int(t.shape[1] * t.element_size() % 16 == 0
               and all(u.data_ptr() % 16 == 0 for u in tensors
                       if u is not None))


def _like(x: torch.Tensor, t, name: str):
    """``t`` (a residual or a saved output; None stays None) checked
    against ``x`` and in ``channels_last`` memory."""
    if t is None:
        return None
    if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"does not match x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return t.contiguous(memory_format=torch.channels_last)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _params(c: int, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if (t.dtype != torch.float32 or t.shape != (c,)
                or not t.is_contiguous()):
            raise ValueError("parameters and statistics must be f32 [C], "
                             f"contiguous; got {t.dtype} {tuple(t.shape)}")


def _rows(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[2] * x.shape[3]


def batch_norm_train_cuda(x, weight, bias, running_mean, running_var,
                          num_batches_tracked, momentum: float, eps: float,
                          relu: bool, residual=None):
    """(y, mean, invstd) of a training forward; ``running_mean``,
    ``running_var`` and ``num_batches_tracked`` updated in place.

    On a CUDA tensor this launches the three forward kernels (or raises):
    ``x`` bf16 or f32 ``[N, C, H, W]`` (made ``channels_last`` first), the
    parameters and statistics f32 ``[C]``; ``y`` in ``x``'s dtype,
    ``channels_last``; ``mean`` and ``invstd`` f32 ``[C]``. With a
    ``residual`` (``x``'s shape and dtype) ``y`` is ``relu(bn(x) +
    residual)``, computed by the apply stage in its one pass. On a CPU
    tensor it computes the plain twin. ``batch_norm_train_cuda.launches``
    counts the kernel launches, ``.residuals`` the calls with a residual
    on either device."""
    batch_norm_train_cuda.residuals += residual is not None
    if x.device.type == "cpu":
        return batch_norm_train_plain(x, weight, bias, running_mean,
                                      running_var, num_batches_tracked,
                                      momentum, eps, relu, residual)
    x = _layout(x, weight)
    act, residual = _act(relu, residual), _like(x, residual, "residual")
    c, rows = x.shape[1], _rows(x)
    _params(c, weight, bias, running_mean, running_var)
    if rows < 2:
        raise ValueError("training BatchNorm needs more than one value a "
                         f"channel, got input {tuple(x.shape)}")
    if num_batches_tracked.dtype != torch.int64:
        raise TypeError("num_batches_tracked must be int64")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    index, dtype, vec = x.device.index, DTYPES[x.dtype], _vec(x, y, residual)
    tc, tr, splits, chunk = _stage_plan(index, FW_PARTIALS, dtype, vec, rows,
                                        c)
    _, _, asplits, achunk = _stage_plan(index, FW_APPLY, dtype, vec, rows, c)
    part = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().lh_bn_forward_train(
            x.data_ptr(), _ptr(residual), y.data_ptr(), rows, c, dtype, vec,
            tc, tr, splits, chunk, asplits, achunk, weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            num_batches_tracked.data_ptr(), momentum, eps, act,
            part.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        batch_norm_train_cuda.launches += 3
    if err:
        raise RuntimeError(f"batch norm forward launch failed: CUDA error "
                           f"{err}")
    return y, stats[0], stats[1]


def batch_norm_eval_cuda(x, weight, bias, running_mean, running_var,
                         eps: float, relu: bool, residual=None):
    """The eval forward from the running statistics, in ``x``'s dtype
    (with a ``residual``: ``relu(bn(x) + residual)``): one launch on a CUDA
    tensor (or raises), the plain twin on a CPU tensor.
    ``batch_norm_eval_cuda.launches`` counts the kernel launches,
    ``.residuals`` the calls with a residual on either device."""
    batch_norm_eval_cuda.residuals += residual is not None
    if x.device.type == "cpu":
        return batch_norm_eval_plain(x, weight, bias, running_mean,
                                     running_var, eps, relu, residual)
    x = _layout(x, weight)
    act, residual = _act(relu, residual), _like(x, residual, "residual")
    c, rows = x.shape[1], _rows(x)
    _params(c, weight, bias, running_mean, running_var)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if rows == 0:
        return y
    index, dtype, vec = x.device.index, DTYPES[x.dtype], _vec(x, y, residual)
    tc, tr, splits, chunk = _stage_plan(index, FW_EVAL, dtype, vec, rows, c)
    with torch.cuda.device(x.device):
        err = _lib().lh_bn_forward_eval(
            x.data_ptr(), _ptr(residual), y.data_ptr(), rows, c, dtype, vec,
            tc, tr, splits, chunk, weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), eps, act,
            torch.cuda.current_stream().cuda_stream)
        batch_norm_eval_cuda.launches += 1
    if err:
        raise RuntimeError(f"batch norm eval launch failed: CUDA error {err}")
    return y


def batch_norm_backward_cuda(dy, x, weight, bias, stat0, stat1,
                             training: bool, eps: float, relu: bool,
                             out=None):
    """(dx, dw, db) of either forward: ``stat0``, ``stat1`` are the saved
    ``mean`` and ``invstd`` in training, the running mean and variance in
    eval. ``dx`` in ``x``'s dtype, ``channels_last``; ``dw``, ``db`` f32.
    With ``out``, the saved output of a forward with a residual, (dx, dw,
    db, dr): ``dy`` gated by ``out > 0`` runs through the BatchNorm's
    backward, and is itself ``dr``, the residual's gradient.

    On a CUDA tensor this launches the three backward kernels (or raises);
    on a CPU tensor it computes the plain twin (which takes the running
    statistics in eval and ignores the saved ones in training).
    ``batch_norm_backward_cuda.launches`` counts the kernel launches,
    ``.residuals`` the calls with ``out`` on either device."""
    batch_norm_backward_cuda.residuals += out is not None
    if x.device.type == "cpu":
        return batch_norm_backward_plain(dy, x, weight, bias, stat0, stat1,
                                         training, eps, relu, out)
    x = _layout(x, weight)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous(memory_format=torch.channels_last)
    act, out = _act(relu, out), _like(x, out, "out")
    c, rows = x.shape[1], _rows(x)
    _params(c, weight, bias, stat0, stat1)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    dr = (None if out is None
          else torch.empty_like(x, memory_format=torch.channels_last))
    dw = torch.empty(c, dtype=torch.float32, device=x.device)
    db = torch.empty(c, dtype=torch.float32, device=x.device)
    if rows == 0:
        grads = dx, dw.zero_(), db.zero_()
        return grads if out is None else grads + (dr,)
    index, dtype, vec = (x.device.index, DTYPES[x.dtype],
                         _vec(x, dy, dx, out, dr))
    tc, tr, splits, chunk = _stage_plan(index, BW_PARTIALS, dtype, vec, rows,
                                        c)
    _, _, asplits, achunk = _stage_plan(index, BW_APPLY, dtype, vec, rows, c)
    part = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((3, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().lh_bn_backward(
            dy.data_ptr(), x.data_ptr(), _ptr(out), dx.data_ptr(), _ptr(dr),
            rows, c, dtype, vec, tc, tr, splits, chunk, asplits, achunk,
            weight.data_ptr(), bias.data_ptr(), stat0.data_ptr(),
            stat1.data_ptr(), int(not training), eps, act, part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), coef.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        batch_norm_backward_cuda.launches += 3
    if err:
        raise RuntimeError(f"batch norm backward launch failed: CUDA error "
                           f"{err}")
    return (dx, dw, db) if out is None else (dx, dw, db, dr)


batch_norm_train_cuda.launches = batch_norm_train_cuda.residuals = 0
batch_norm_eval_cuda.launches = batch_norm_eval_cuda.residuals = 0
batch_norm_backward_cuda.launches = batch_norm_backward_cuda.residuals = 0


# ------------------------------------------------------------- autograd


class _BatchNorm(torch.autograd.Function):
    """Forward and backward through the kernels on the card: saves ``x``
    in its own dtype and, in training, the f32 ``mean`` and ``invstd`` (in
    eval the running statistics), no f32 copy of ``x``; the output only
    where the forward took a residual, for the ReLU's gate (the next conv
    saves that output as its input, as the ReLU after the add saved it)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                num_batches_tracked, residual, training, momentum, eps,
                relu):
        ctx.conf = (training, eps, relu)
        if training:
            y, s0, s1 = batch_norm_train_cuda(
                x, weight, bias, running_mean, running_var,
                num_batches_tracked, momentum, eps, relu, residual)
        else:
            y = batch_norm_eval_cuda(x, weight, bias, running_mean,
                                     running_var, eps, relu, residual)
            s0, s1 = running_mean, running_var
        ctx.save_for_backward(x, weight, bias, s0, s1,
                              None if residual is None else y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, s0, s1, out = ctx.saved_tensors
        training, eps, relu = ctx.conf
        grads = batch_norm_backward_cuda(dy, x, weight, bias, s0, s1,
                                         training, eps, relu, out)
        dr = grads[3] if out is not None else None
        need = ctx.needs_input_grad
        return tuple(g if n else None for g, n in zip(
            grads[:3] + (None,) * 3 + (dr,), need)) + (None,) * 4


def batch_norm(x, weight, bias, running_mean, running_var,
               num_batches_tracked, training: bool, momentum: float,
               eps: float, relu: bool = False,
               residual=None) -> torch.Tensor:
    """BatchNorm over (N, H, W) of ``x`` ``[N, C, H, W]`` with f32
    parameters, in training (batch statistics; the running ones updated in
    place) or eval (the running statistics), then ReLU if ``relu``; with a
    ``residual``, ``relu(bn(x) + residual)`` instead (the end of a residual
    block: on the card in the apply stage's one pass); the result in
    ``x``'s dtype. On the card a gradient goes through the kernels'
    autograd Function; on the CPU autograd differentiates the twin, and
    where no gradient is wanted the forward runs alone."""
    if x.device.type == "cpu" or not (
            torch.is_grad_enabled()
            and any(t is not None and t.requires_grad
                    for t in (x, weight, bias, residual))):
        if training:
            return batch_norm_train_cuda(x, weight, bias, running_mean,
                                         running_var, num_batches_tracked,
                                         momentum, eps, relu, residual)[0]
        return batch_norm_eval_cuda(x, weight, bias, running_mean,
                                    running_var, eps, relu, residual)
    return _BatchNorm.apply(x, weight, bias, running_mean, running_var,
                            num_batches_tracked, residual, training,
                            momentum, eps, relu)
