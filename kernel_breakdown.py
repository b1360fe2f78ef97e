#!/usr/bin/env python3
"""How fast each of the port's CUDA kernels runs alone on one NVIDIA GPU,
against the least time its work can take there.

    python3 kernel_breakdown.py                 # this checkout's kernels
    python3 kernel_breakdown.py --root DIR      # the kernels of another
                                                # checkout (e.g. a parent
                                                # commit unpacked in DIR)

With ``--root``, run parent, change, change, parent in one call to compare
two commits. Each kernel runs alone on seeded inputs
(``tests/torch_fixtures.py``): its device ms (one call captured in a CUDA
graph and replayed 20 times between two events, or the profiler's kernel
time where capture refuses the call or where a call's kernels are picked
out by name), its eager ms (events around 20 back-to-back calls, over 20:
launch cost and device time together), its plain twin's ms and, where
PyTorch does the same work in one call, that call's device ms. Each bound
is the least time of the work on the card: bytes over the memory rate or
operations over the peak rate of their type (f32, int8 tensor-core or f64
operations), whichever is larger, on the benchmark's yardstick
(``benchmark/lhbench/yardstick.py``: ``peaks``, ``k1_work``, ``k2_work``,
``K1_OPS_PER_PIXEL``, ``TARGET_OPS_PER_ELEMENT``). A ``[row]`` line for each
row of PERF.md's two kernel tables:

- K1 (fused aug + targets) and K2 (heatmap targets) at B=32 and B=128,
  256x256, 64x64 maps; at B=32 (about 30 MB, inside the 50 MB L2) also
  with the L2 flushed by a 128 MB write before each call; K1 at B=128
  under op mixes that isolate its parts, and its SASS instruction and
  MUFU.RCP counts where ``cuobjdump`` is found;
- the int8 conv (bf16 in and out, batch 32) at each model's heaviest shape
  and its Cin-3 stem, beside ``torch._int_mm`` on the pre-quantized im2col
  (K zero-padded to a multiple of 8, checked equal to the kernel) and
  cuDNN's bf16 conv; the weight quantize of each such weight; the grouped
  weight quantize over all 292 HRNet-W32 and 53 ResNet-50 weights, beside
  a launch a conv; a forward's quantized convs, shape by shape, and the
  host us of a ``quant_forward`` call;
- the eval forward of ResNet-50 and HRNet-W32 at bs32 under bf16 and
  int8_fwd: ms a forward, host ms, the profiler's kernel ms and count;
- the BatchNorm kernels (bf16, ReLU) at every BatchNorm shape of HRNet-W32
  at bs128 and ResNet-50 at bs32, each stage beside its byte bound, summed
  over a microbatch, beside the twin and ``F.batch_norm`` + ``relu``; the
  rows at each model's largest and smallest shape; a residual block's end
  at each model's largest, beside the chain it replaced; a graphed W32
  bs128 training microbatch and eval batch with the BatchNorms through the
  kernels and through that library call (kernels, library, library,
  kernels);
- the mesh rasterizer on ``procedural_hand_mesh`` at 800x600 and 224x224;
- beside K1: the flip / rotation chain at B=128 and the jittering
  ``DevicePreprocessor`` at B=32; the host ms of the codec (224x224 JPEG
  decode, resize to 256, warp to 224; JPEG encode at quality 95) and of
  one ``draw_text`` caption.

f32 math is full f32 (both TF32 switches off). The last line is one JSON
object with every number. Without a card it exits nonzero.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(REPO, "tests"))
sys.path.append(os.path.join(REPO, "benchmark"))

import torch_fixtures as fx  # noqa: E402
from lhbench import yardstick  # noqa: E402

# columns of a yardstick peak row: operations/s of each type
F32, INT8, F64 = 1, 2, 3
# f32 operations per weight of the weight quantize: |w| and its max, then
# the division, the rounding and the two-sided clamp
WEIGHT_OPS_PER_VALUE = 6
# f64 operations of the rasterizer: at each pixel of a drawn face's box,
# two barycentrics (12), w0 (2), the inside test (3), 1/z (5), the depth
# (2) and its two compares (2); at each covered pixel, three channels of
# three (w * c) / z terms summed (24) and times the depth (3)
RASTER_OPS_PER_BOX_PIXEL = 26
RASTER_OPS_PER_COVERED_PIXEL = 27
# bytes an element each BatchNorm stage moves in 2-byte elements: x once
# for the statistics; x in, y out; dy and x for the sums; dy and x in, dx
# out; x in, y out from the running statistics
BN_STAGE_BYTES = {"lh_bn_fw_partials": 2, "lh_bn_fw_apply": 4,
                  "lh_bn_bw_partials": 4, "lh_bn_bw_apply": 6,
                  "lh_bn_fw_eval": 4, "lh_bn_fw_finalize": 0,
                  "lh_bn_bw_finalize": 0}
# bytes an element of a residual block's end, (training forward + backward,
# eval), in 2-byte elements. The one pass: x for the statistics; x and r
# in, o out; dy, x and o for the sums; dy, x and o in, dx and dr out; eval
# x and r in, o out. The chain: the stages without the ReLU, the add (y
# and r in, the sum out), the ReLU (the sum in, o out), its backward (dy
# and o in, dy' out).
RESIDUAL_BYTES = {"fused": (2 + 6 + 6 + 10, 6),
                  "chain": (2 + 4 + 6 + 4 + 6 + 4 + 6, 4 + 6 + 4)}
MIXES = {  # name: (enable, op order or None for the 24 orders)
    "jitter off": (0.0, None),
    "brightness x4": (1.0, [0, 0, 0, 0]),
    "saturation x4": (1.0, [2, 2, 2, 2]),
    "hue x4": (1.0, [3, 3, 3, 3]),
    "contrast x4": (1.0, [1, 1, 1, 1]),
    "24 orders, all jittered": (1.0, None),
}
ROWS = []  # every [row] printed, for the JSON line


def bound_ms(nbytes: float, ops: float, kind: str, rate: int = F32):
    """(ms, "bytes" or "operations"): the least time for the work, bytes
    over the memory rate or operations over column ``rate`` of the
    yardstick's peak row, whichever is larger."""
    row = yardstick.peaks(kind)
    t_bytes, t_ops = nbytes / row[0] * 1e3, ops / row[rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def target_work(b: int) -> dict:
    """{kernel: (bytes, operations)} of K1 and K2 at batch ``b``, 256x256,
    64x64 maps, as the yardstick counts them."""
    return {"fused_aug_targets": yardstick.k1_work(b, fx.SIZE, fx.JOINTS,
                                                   fx.HM),
            "heatmap_targets": yardstick.k2_work(b, fx.JOINTS, fx.HM)}


def _fmt(v) -> str:
    return ("none" if v is None else f"{v:.4f}" if isinstance(v, float)
            else str(v))


def row(kernel: str, shape: str, device: float, eager, bound: tuple,
        plain=None, library=None, **extra) -> dict:
    """Print one row of the kernel tables and keep it for the JSON line:
    device ms, eager ms, bound ms (by), % of bound, plain ms, library ms
    and ``extra``."""
    ms, by = bound
    r = {"kernel": kernel, "shape": shape, "device_ms": device,
         "eager_ms": eager, "bound_ms": ms, "bound_by": by,
         "pct_of_bound": 100 * ms / device, "plain_ms": plain,
         "library_ms": library, **extra}
    ROWS.append(r)
    print(f"[row] {kernel} | {shape} | device {device:.4f} ms | eager "
          f"{_fmt(eager)} | bound {ms:.4g} ({by}) | {r['pct_of_bound']:.1f}"
          f" % of bound | plain {_fmt(plain)} | library {_fmt(library)}"
          + "".join(f" | {k} {_fmt(v)}" for k, v in extra.items()))
    return r


# ------------------------------------------------------------------ clocks


def _events():
    import torch

    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def eager_ms(fn, calls: int = 20, warmup: int = 5) -> float:
    """Events around ``calls`` back-to-back calls, over ``calls``: launch
    cost and device time together, as a caller sees them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def capture(fn):
    """``fn`` captured once in a CUDA graph after a warm-up on a side
    stream, or None (with the reason printed) where capture refuses it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as exc:
        print(f"note: CUDA graph capture refused: {exc}")
        return None
    return graph


def device_ms(fn, graph=None, calls: int = 20):
    """(ms per call on the device, how it was measured): replays of
    ``graph`` between two events, or the profiler's summed kernel time of
    ``fn`` where there is no graph."""
    import torch

    if graph is not None:
        graph.replay()
        torch.cuda.synchronize()
        start, end = _events()
        start.record()
        for _ in range(calls):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls, "cuda graph"
    return kernel_ms(fn, ("",), calls)[0], "profiler"


def graphed_ms(fn, calls: int = 20) -> tuple:
    """``device_ms`` of ``fn`` captured in a CUDA graph."""
    return device_ms(fn, capture(fn), calls)


def profiled(fn, calls: int = 20) -> list:
    """[(kernel name, device ms a call, launches a call)] of ``calls``
    calls of ``fn`` after one more, by the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]


def kernel_ms(fn, names, calls: int = 20) -> tuple:
    """(the profiler's device ms a call, kernels a call) of the kernels
    whose names hold one of ``names`` (a wrapper's checks and copies left
    out)."""
    picked = [k for k in profiled(fn, calls) if any(n in k[0] for n in names)]
    return sum(k[1] for k in picked), sum(k[2] for k in picked)


def flushed_ms(run, flush, calls: int = 20) -> float:
    """Mean of ``calls`` calls of ``run``, each timed by its own events
    after ``flush`` has evicted the L2 cache."""
    import torch

    run()
    pairs = []
    for _ in range(calls):
        flush()
        start, end = _events()
        start.record()
        run()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / calls


def host_us(fn, calls: int = 400) -> float:
    """Host microseconds a call: ``calls`` calls between two clock reads
    (the card keeps up at the small shape it is used at), synchronised
    around."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


# ------------------------------------------------------------ K1 and K2


def sass_counts(lib_path: str):
    """{kernel: [instructions, MUFU.RCP]} of K1's library (its bf16 and f32
    variants and the division check) from cuobjdump, or None."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = ("division check" if "div_mismatch" in m.group(1)
                    else "bf16" if "bfloat16" in m.group(1) else "f32")
            counts[name] = [0, 0]
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[name][0] += 1
            counts[name][1] += "MUFU.RCP" in line
    return counts


def targets(kind: str) -> dict:
    """K1 and K2 at B=32 and B=128 (rows), B=32 also with the L2 flushed;
    then K1 at B=128 under ``MIXES``. Returns {mix: device ms}."""
    import torch

    from lighthand_tpu_torch.ops.heatmap import generate_target_batch
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        fused_aug_targets_cuda,
        fused_aug_targets_plain,
    )
    from lighthand_tpu_torch.ops.kernels.heatmap import (
        generate_target_batch_cuda,
    )

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    mixes = {}
    for b, seed in ((fx.B_TRAIN, 2), (fx.B_KERNEL, 1)):
        images, joints, params = fx.k1_inputs(b, seed)
        calls = {"fused_aug_targets": (
            lambda: fused_aug_targets_cuda(images, joints, params),
            lambda: fused_aug_targets_plain(images, joints, params)),
            "heatmap_targets": (lambda: generate_target_batch_cuda(joints),
                                lambda: generate_target_batch(joints))}
        for name, (fn, plain) in calls.items():
            nbytes, ops = target_work(b)[name]
            eager, plain_ms = eager_ms(fn), eager_ms(plain)
            graph = capture(fn)
            dev, how = device_ms(fn, graph)
            extra = {}
            if b == fx.B_TRAIN:
                extra["l2_flushed_eager_ms"] = flushed_ms(fn, flush.zero_)
                extra["l2_flushed_device_ms"] = (
                    None if graph is None
                    else flushed_ms(graph.replay, flush.zero_))
            row(name, f"B={b}, {fx.SIZE}x{fx.SIZE}, {fx.HM}x{fx.HM} maps",
                dev, eager, bound_ms(nbytes, ops, kind), plain_ms, None,
                how=how, work=f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop",
                **extra)
            del graph
    for mix, (enable, order) in MIXES.items():  # on the B=128 inputs
        p = params.clone()
        p[:, 0] = enable
        if order is not None:
            p[:, 5:9] = torch.tensor(order, dtype=torch.float32,
                                     device=p.device)
        mixes[mix], how = graphed_ms(
            lambda: fused_aug_targets_cuda(images, joints, p))
        print(f"[K1 mix] B={fx.B_KERNEL} {mix}: device {mixes[mix]:.4f} ms "
              f"({how})")
    return mixes


# ---------------------------------------------------------------- int8


def int8_times(kind: str, name: str, shape, seed: int) -> None:
    """The int8 conv (batch 32, bf16 in and out) and the weight quantize of
    its weight (a group of one) at one conv shape, a row each: the conv
    beside ``torch._int_mm`` on the pre-quantized im2col of the same
    operands (K zero-padded to a multiple of 8 in both: the GEMM alone,
    the same sums; checked equal to the kernel) and cuDNN's bf16 conv of
    the shape, which the bf16 policy runs."""
    import torch
    import torch.nn.functional as F

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        out_size,
        quantize_activation,
        quantize_weight_cuda,
        quantize_weight_plain,
    )

    cin, h, w, cout, k, stride = shape
    pad, n, clip = k // 2, fx.B_TRAIN, fx.ACT_CLIP
    x, wt = fx.int8_inputs(n, shape, seed)
    w_q, _, scale = quantize_weight_cuda(wt, clip)

    def conv():
        return int8_conv2d_cuda(x, w_q, scale, clip, stride, pad)
    dev, how = graphed_ms(conv)
    plain = eager_ms(lambda: fx.int8_twin(x, w_q, scale, stride, pad,
                                          torch.bfloat16), calls=5)
    m = n * out_size(h, k, stride, pad) * out_size(w, k, stride, pad)
    ops = fx.conv_ops(n, shape)
    # bf16 activations in, s8 weights and f32 scales, bf16 out
    nbytes = 2 * x.numel() + w_q.numel() + 4 * cout + 2 * m * cout

    kk = cin * k * k
    kp = -(-kk // 8) * 8  # K padded with zeros: _int_mm takes K % 8 == 0
    library = None
    if cout % 8 == 0 and m > 16:
        cols = F.unfold(quantize_activation(x, clip).float(), k,
                        padding=pad, stride=stride)
        a = torch.zeros((m, kp), dtype=torch.int8, device=x.device)
        a[:, :kk] = cols.transpose(1, 2).reshape(m, kk).to(torch.int8)
        del cols
        b = torch.zeros((cout, kp), dtype=torch.int8, device=x.device)
        b[:, :kk] = w_q.permute(0, 3, 1, 2).reshape(cout, kk)
        b = b.t()
        try:
            acc = torch._int_mm(a, b)
        except RuntimeError as exc:  # a yardstick; the port never calls it
            print(f"note: torch._int_mm refused {shape} (K {kk} -> {kp}): "
                  f"{exc}")
        else:
            got = conv().permute(0, 2, 3, 1).reshape(m, cout)
            if not torch.equal((acc.float() * scale).to(torch.bfloat16), got):
                raise RuntimeError(f"torch._int_mm and the int8 kernel "
                                   f"disagree at {shape}")
            library = graphed_ms(lambda: torch._int_mm(a, b))[0]
        del a, b
    x16 = x.contiguous(memory_format=torch.channels_last)
    w16 = wt.to(torch.bfloat16)
    cudnn = graphed_ms(lambda: F.conv2d(x16, w16, None, stride, pad))[0]
    row("int8 conv", f"{name} {shape}, N={n}", dev, eager_ms(conv),
        bound_ms(nbytes, ops, kind, INT8), plain, library, how=how,
        int_mm_k=f"{kk} -> {kp}", cudnn_bf16_ms=cudnn,
        plan=conv_plan(x, w_q, stride, pad)["path"],
        work=f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop")

    def weight():
        return quantize_weight_cuda(wt, clip)
    nw = wt.numel()
    # f32 in, s8 out, s_w and scale out
    row("weight quantize (one weight)", f"{name} {cout}x{cin}x{k}x{k}",
        graphed_ms(weight)[0], eager_ms(weight),
        bound_ms(5 * nw + 8 * cout, WEIGHT_OPS_PER_VALUE * nw, kind),
        eager_ms(lambda: quantize_weight_plain(wt, clip)))


def grouped_times(kind: str) -> dict:
    """The grouped weight kernel over each whole model's weights
    (``model_quant_weights``, channels_last), a row each: bound 5 bytes a
    weight and 8 a channel; beside the same weights a launch a conv (a
    group of one each) and a call's host us. Returns {model: device ms}."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        quantize_weight_cuda,
        quantize_weights_cuda,
        quantize_weights_plain,
    )

    out = {}
    for name in ("hrnet_w32", "resnet50"):
        ws = fx.model_quant_weights(name, torch.channels_last)
        group = lambda: quantize_weights_cuda(ws, fx.ACT_CLIP)  # noqa: E731
        per_conv = lambda: [quantize_weight_cuda(w, fx.ACT_CLIP)  # noqa
                            for w in ws]
        values = sum(w.numel() for w in ws)
        channels = sum(w.shape[0] for w in ws)
        nbytes = 5 * values + 8 * channels
        eager = eager_ms(group)
        out[name], how = graphed_ms(group)
        per_eager = eager_ms(per_conv, calls=5)
        per_dev = graphed_ms(per_conv, calls=5)[0]
        row("weight quantize, grouped", f"{name}: {len(ws)} weights, "
            f"{values} values", out[name], eager,
            bound_ms(nbytes, WEIGHT_OPS_PER_VALUE * values, kind),
            eager_ms(lambda: quantize_weights_plain(ws, fx.ACT_CLIP),
                     calls=3, warmup=1), how=how, per_conv_device_ms=per_dev,
            per_conv_eager_ms=per_eager, host_us=host_us(group, calls=50),
            work=f"{nbytes / 1e6:.1f} MB")
        del ws
    return out


def quant_forward_times(shapes: dict, grouped: dict) -> dict:
    """A forward's quantized convs, every distinct shape of ResNet-50 and
    HRNet-W32 at batch 32 with bf16 activations: the device time of
    ``ops/quant.py:quant_forward`` with a conv's own weight quantize (a
    group of one, as a ``QuantConv2d`` called on its own) and of the conv
    alone, times the shape's uses, summed a forward; a forward's quantized
    convs are the convs alone and one grouped weight quantize
    (``grouped``). Then the host us a call of ``quant_forward``, its
    weights quantized already (as in a model's forward) and quantizing its
    own, beside a bf16 conv with its weight cast (4 x 32 x 16 x 16, 3x3)."""
    import torch
    import torch.nn.functional as F

    from lighthand_tpu_torch.ops import quant
    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        quantize_weight_cuda,
    )

    clip, result = fx.ACT_CLIP, {}
    for name, uses in sorted(shapes.items()):
        rows = []
        for shape, u in sorted(uses.items()):
            k, s = shape[4], shape[5]
            x, wt = fx.int8_inputs(fx.B_TRAIN, shape, 7)
            w_q, _, scale = quantize_weight_cuda(wt, clip)
            rows.append((shape, u, graphed_ms(lambda: quant.quant_forward(
                x, wt, s, k // 2, clip, torch.bfloat16))[0],
                graphed_ms(lambda: int8_conv2d_cuda(
                    x, w_q, scale, clip, s, k // 2))[0],
                conv_plan(x, w_q, s, k // 2)["path"]))
            del x, wt, w_q, scale
        own = sum(u * ms for _, u, ms, _, _ in rows)
        conv = sum(u * ms for _, u, _, ms, _ in rows)
        result[name] = {"quantized_conv_ms": conv + grouped[name],
                        "conv_ms": conv, "per_conv_quantize_ms": own}
        print(f"[int8 convs] {name} bs{fx.B_TRAIN}: {conv + grouped[name]:.4f}"
              f" ms device time a forward in quantized convs ({len(rows)} "
              f"shapes, {sum(r[1] for r in rows)} convs): the conv kernel "
              f"{conv:.4f} ms and one grouped weight quantize "
              f"{grouped[name]:.4f} ms; with a quantize a conv {own:.4f} ms;"
              " the heaviest (shape x uses: ms a call with its quantize / "
              "conv, path):")
        for shape, u, ms, c_ms, path in sorted(
                rows, key=lambda r: -r[1] * r[2])[:6]:
            print(f"    {shape} x{u}: {ms:.4f} / {c_ms:.4f} ms {path}")
    x = torch.randn(4, 32, 16, 16, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    wt = torch.randn(32, 32, 3, 3, device="cuda").contiguous(
        memory_format=torch.channels_last)
    made = quant.quantize_group([wt], clip)[0]
    result["host_us"] = {
        "quant_forward": host_us(lambda: quant.quant_forward(
            x, wt, 1, 1, clip, torch.bfloat16, made)),
        "quant_forward_own_quantize": host_us(lambda: quant.quant_forward(
            x, wt, 1, 1, clip, torch.bfloat16)),
        "bf16_cast_and_conv": host_us(lambda: F.conv2d(
            x, wt.to(torch.bfloat16), None, 1, 1))}
    print(f"[int8 convs] host us a call: {result['host_us']}")
    return result


def forwards() -> dict:
    """{"model policy": figures} of the eval forward of ResNet-50 and
    HRNet-W32 at bs32, 256x256, under bf16 and int8_fwd (the same random
    weights): events around 5 blocks of 4 forwards after 3 warm-ups, the
    host ms a forward of 4 unsynchronised calls, and the profiler's
    device ms and kernel count a forward over 3, with the weight
    quantize's share and the kernels that take the most."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import init_weights

    x = torch.randn(fx.B_TRAIN, 3, fx.SIZE, fx.SIZE, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    out = {}
    for name in ("resnet50", "hrnet_w32"):
        for tag, policy in (("bf16", DTypePolicy()),
                            ("int8_fwd", DTypePolicy.int8_fwd())):
            model = get_model(name, policy=policy)
            init_weights(model, torch.Generator().manual_seed(0))
            model = model.eval().to("cuda", memory_format=torch.channels_last)
            with torch.no_grad():
                blocks = sorted(eager_ms(lambda: model(x), calls=4,
                                         warmup=3) for _ in range(5))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    model(x)
                host = (time.perf_counter() - t0) / 4 * 1e3
                kernels = sorted(((ms, n, key) for key, ms, n
                                  in profiled(lambda: model(x), calls=3)),
                                 reverse=True)
            quant = [k for k in kernels if "quantize_weight" in k[2]]
            fig = {"ms": blocks, "host_ms": host,
                   "kernel_ms": sum(k[0] for k in kernels),
                   "kernels": sum(k[1] for k in kernels),
                   "quantize_ms": sum(k[0] for k in quant),
                   "quantize_launches": sum(k[1] for k in quant)}
            out[f"{name} {tag}"] = fig
            print(f"[forward] {name} {tag} bs{fx.B_TRAIN}: ms a forward "
                  f"(5 blocks of 4) {[round(t, 3) for t in blocks]}, host "
                  f"{host:.3f} ms, kernels {fig['kernel_ms']:.3f} ms x"
                  f"{fig['kernels']:g} "
                  f"({100 * fig['kernel_ms'] / blocks[2]:.1f} % busy), "
                  f"weight quantize {fig['quantize_ms']:.4f} ms x"
                  f"{fig['quantize_launches']:g}; top kernels (ms a forward, "
                  "launches): " + "; ".join(f"{key[:48]} {ms:.3f} x{n:g}"
                                            for ms, n, key in kernels[:6]))
            del model
    return out


def int8(kind: str) -> dict:
    """Every int8 row, the grouped weight quantize and a forward's
    quantized convs. Returns the forward figures."""
    shapes = {name: fx.quant_conv_shapes(name)
              for name in ("resnet50", "hrnet_w32")}
    for i, (name, uses) in enumerate(sorted(shapes.items())):
        heavy = fx.heaviest_shape(uses)
        stem = next(key for key in uses if key[0] % 32)
        gop = fx.conv_ops(fx.B_TRAIN, heavy) * uses[heavy] / 1e9
        print(f"[int8] {name}: heaviest shape (Cin, H, W, Cout, k, s) {heavy}"
              f" x{uses[heavy]}, {gop:.1f} Gop a forward at bs32; stem "
              f"{stem}")
        int8_times(kind, name, heavy, 900 + i)
        int8_times(kind, f"{name} stem", stem, 910 + i)
    return quant_forward_times(shapes, grouped_times(kind))


# ---------------------------------------------------------- batch norm


def bn_stage_ms(fn, calls: int = 10) -> dict:
    """{kernel name: device ms a call} of the lh_bn_ kernels ``fn``
    launches, over replays of ``fn`` captured in a CUDA graph."""
    graph = capture(fn)
    if graph is None:
        raise RuntimeError("a BatchNorm call could not be captured")
    kernels = profiled(graph.replay, calls)
    return {stage: sum(ms for key, ms, _ in kernels if stage in key)
            for stage in BN_STAGE_BYTES}


def bn_times(n, c, h, w) -> dict:
    """Device ms of each stage (graph replays, the profiler's kernel
    times); device and eager ms of the training forward + backward and of
    the eval forward; the device ms of the same two through the twin (the
    port's chain before the kernels: the f32 copy, ``var_mean``,
    ``F.batch_norm``, the cast back, ``relu``) and through the library's
    one call: ``F.batch_norm`` on the bf16 activation with the f32
    parameters, its own statistics pass, then ``relu`` (a timing only: it
    updates the running variance with the unbiased variance, not Flax's
    biased one). bf16, ReLU on."""
    import torch
    import torch.nn.functional as F

    from lighthand_tpu_torch.ops.kernels import batch_norm as bn

    x, dy, wt, b, rm, rv = fx.bn_inputs(n, c, h, w, torch.bfloat16, 11)
    nb = torch.zeros((), dtype=torch.long, device="cuda")

    def train():
        y, s0, s1 = bn.batch_norm_train_cuda(x, wt, b, rm, rv, nb, 0.1, 1e-5,
                                             True)
        bn.batch_norm_backward_cuda(dy, x, wt, b, s0, s1, True, 1e-5, True)

    def evaluate():
        bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, True)

    def chain(fn):
        def run():
            with torch.enable_grad():
                xg = x.detach().requires_grad_()
                torch.autograd.grad(fn(xg), xg, dy)
        return run

    stages = bn_stage_ms(train)
    stages["lh_bn_fw_eval"] = bn_stage_ms(evaluate)["lh_bn_fw_eval"]
    t = {"stages": stages, "elements": n * c * h * w,
         "train_device_ms": sum(ms for s, ms in stages.items()
                                if s != "lh_bn_fw_eval"),
         "train_eager_ms": eager_ms(train),
         "eval_device_ms": stages["lh_bn_fw_eval"],
         "eval_eager_ms": eager_ms(evaluate)}
    for name, fn in (
            ("plain", chain(lambda xg: bn.batch_norm_train_plain(
                xg, wt, b, rm, rv, nb, 0.1, 1e-5, True)[0])),
            ("library", chain(lambda xg: torch.relu(F.batch_norm(
                xg, rm, rv, wt, b, True, 0.1, 1e-5)))),
            ("plain_eval", lambda: bn.batch_norm_eval_plain(
                x, wt, b, rm, rv, 1e-5, True)),
            ("library_eval", lambda: torch.relu(F.batch_norm(
                x, rm, rv, wt, b, False, 0.0, 1e-5)))):
        t[f"{name}_device_ms"] = graphed_ms(fn)[0]
    return t


def bn_rows(kind: str, model: str, size: str, shape, t: dict) -> None:
    """The training and eval rows of one BatchNorm shape."""
    el = t["elements"]
    label = f"{model}'s {size} {tuple(shape)}, bf16, ReLU"
    row("BatchNorm(+ReLU), training forward + backward", label,
        t["train_device_ms"], t["train_eager_ms"],
        bound_ms(16 * el, 0, kind), t["plain_device_ms"],
        t["library_device_ms"])
    row("BatchNorm(+ReLU), eval", label, t["eval_device_ms"],
        t["eval_eager_ms"], bound_ms(4 * el, 0, kind),
        t["plain_eval_device_ms"], t["library_eval_device_ms"])


def bn_residual_rows(kind: str, model: str, n, c, h, w) -> None:
    """A residual block's end, bf16, at one shape, training forward +
    backward and eval: the kernels' one pass against the chain it replaced
    (the kernels with ``relu=False``, the add, ``relu``,
    ``threshold_backward``), each beside its byte bound
    (``RESIDUAL_BYTES``)."""
    import torch

    from lighthand_tpu_torch.ops.kernels import batch_norm as bn

    x, dy, wt, b, rm, rv = fx.bn_inputs(n, c, h, w, torch.bfloat16, 12)
    r = fx.bn_inputs(n, c, h, w, torch.bfloat16, 13)[0]
    nb = torch.zeros((), dtype=torch.long, device="cuda")

    def fused_train():
        o, s0, s1 = bn.batch_norm_train_cuda(x, wt, b, rm, rv, nb, 0.1, 1e-5,
                                             False, r)
        bn.batch_norm_backward_cuda(dy, x, wt, b, s0, s1, True, 1e-5, False,
                                    out=o)

    def chain_train():
        y, s0, s1 = bn.batch_norm_train_cuda(x, wt, b, rm, rv, nb, 0.1, 1e-5,
                                             False)
        o = torch.relu(y + r)
        dyp = torch.ops.aten.threshold_backward(dy, o, 0)
        bn.batch_norm_backward_cuda(dyp, x, wt, b, s0, s1, True, 1e-5, False)

    def fused_eval():
        bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, False, r)

    def chain_eval():
        torch.relu(bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, False) + r)

    el = n * c * h * w
    for i, (mode, fused, chain) in enumerate((
            ("training forward + backward", fused_train, chain_train),
            ("eval", fused_eval, chain_eval))):
        row(f"Residual block end, {mode}", f"{model}'s largest "
            f"{(n, c, h, w)}, bf16", graphed_ms(fused)[0], eager_ms(fused),
            bound_ms(RESIDUAL_BYTES["fused"][i] * el, 0, kind),
            graphed_ms(chain)[0],
            chain_bound_ms=bound_ms(RESIDUAL_BYTES["chain"][i] * el, 0,
                                    kind)[0])


def batch_norm(kind: str) -> dict:
    """Each stage's device ms beside its byte bound at every BatchNorm shape
    of HRNet-W32 bs128 and ResNet-50 bs32, weighted by uses into each
    model's ms a microbatch; the rows at each model's largest and smallest
    shape and at its largest residual block end. Returns the microbatch
    sums."""
    sums = {}
    for name, batch in fx.BN_MODELS:
        uses, ends = {}, set()
        for (c, h, w, _, residual), k in fx.bn_shapes(name).items():
            uses[batch, c, h, w] = uses.get((batch, c, h, w), 0) + k
            if residual:
                ends.add((batch, c, h, w))
        m = sums.setdefault(name, {})
        times = {}
        for shape, k in sorted(uses.items()):
            t = times[shape] = bn_times(*shape)
            for key in ("train_device_ms", "eval_device_ms", "plain_device_ms",
                        "library_device_ms", "plain_eval_device_ms",
                        "library_eval_device_ms"):
                m[key] = m.get(key, 0.0) + k * t[key]
            for mode, per in (("train", 16), ("eval", 4)):
                m[f"{mode}_bound_ms"] = m.get(f"{mode}_bound_ms", 0.0) + (
                    k * bound_ms(per * t["elements"], 0, kind)[0])
            stages = {s: (round(ms, 5), round(bound_ms(
                BN_STAGE_BYTES[s] * t["elements"], 0, kind)[0], 5))
                for s, ms in t["stages"].items()}
            print(f"[bn time] {name} {shape} x{k}: stages (device ms, bound "
                  f"ms) {stages}; train {t['train_device_ms']:.4f} (eager "
                  f"{t['train_eager_ms']:.4f}); eval "
                  f"{t['eval_device_ms']:.4f} (eager "
                  f"{t['eval_eager_ms']:.4f}); plain "
                  f"{t['plain_device_ms']:.4f} / "
                  f"{t['plain_eval_device_ms']:.4f}, library "
                  f"{t['library_device_ms']:.4f} / "
                  f"{t['library_eval_device_ms']:.4f}")
        print(f"[bn time] {name}: a microbatch's BatchNorms, device ms "
              f"(bound, plain, library): train {m['train_device_ms']:.3f} "
              f"({m['train_bound_ms']:.3f}, {m['plain_device_ms']:.3f}, "
              f"{m['library_device_ms']:.3f}), eval {m['eval_device_ms']:.3f}"
              f" ({m['eval_bound_ms']:.3f}, {m['plain_eval_device_ms']:.3f},"
              f" {m['library_eval_device_ms']:.3f})")
        by_size = sorted(times, key=lambda s: s[0] * s[1] * s[2] * s[3])
        for size, shape in (("largest", by_size[-1]),
                            ("smallest", by_size[0])):
            bn_rows(kind, name, size, shape, times[shape])
        bn_residual_rows(kind, name, *max(
            ends, key=lambda s: s[0] * s[1] * s[2] * s[3]))
    return sums


def bn_route_ms(batch: dict, route, calls: int = 10) -> tuple:
    """(ms a training microbatch, ms an eval batch) of HRNet-W32 with its
    BatchNorms through ``route`` (``ops/kernels/batch_norm.py:batch_norm``'s
    signature), both steps graphed: host wall over ``calls`` replays after
    the eager call and the capture, synchronised at both ends."""
    import torch

    from lighthand_tpu_torch.models import get_model, layers
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_fused_train_step,
    )

    kept = layers.batch_norm
    layers.batch_norm = route
    try:
        state = create_train_state(get_model("hrnet_w32"),
                                   torch.Generator().manual_seed(0), lr=1e-3)
        step, eval_step = make_fused_train_step(scan_steps=1), make_eval_step()
        gen = torch.Generator(device="cuda").manual_seed(1)
        b = batch["joints"].shape[0]
        ev = {"image": torch.randn(b, fx.SIZE, fx.SIZE, 3, device="cuda"),
              "joints": batch["joints"], "valid": torch.ones(b, device="cuda")}
        ms = []
        for run in (lambda: step(state, gen, batch),
                    lambda: eval_step(state, ev)):
            for _ in range(2):  # eager, capture
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / calls)
    finally:
        layers.batch_norm = kept
    del state, step, eval_step
    torch.cuda.empty_cache()
    return tuple(ms)


def bn_routes() -> dict:
    """HRNet-W32 bs128, graphed: a training microbatch and an eval batch
    with the BatchNorms through the kernels and through the library's one
    call (``F.batch_norm`` on the bf16 activation with the f32 parameters,
    then the activation; a timing only, as in ``bn_times``), in the order
    kernels, library, library, kernels. Returns {route: [(train ms, eval
    ms), ...]}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lighthand_tpu_torch.ops.kernels import batch_norm as bn

    def library(x, weight, bias, running_mean, running_var,
                num_batches_tracked, training, momentum, eps, relu=False,
                residual=None):
        y = F.batch_norm(x, running_mean, running_var, weight, bias,
                         training, momentum, eps)
        return bn.activate(y, relu, residual)

    b, size = fx.B_KERNEL, fx.SIZE
    rng = np.random.default_rng(20)
    batch = {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=(b, size, size, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            16, size - 16, size=(b, fx.JOINTS, 2)).astype(np.float32)),
        "aug_enabled": torch.ones(b), "noise_enabled": torch.ones(b)}
    batch = {k: v.cuda() for k, v in batch.items()}
    routes = {"kernels": bn.batch_norm, "library": library}
    ms = {name: [] for name in routes}
    for name in ("kernels", "library", "library", "kernels"):
        ms[name].append(bn_route_ms(batch, routes[name]))
    print(f"[bn routes] HRNet-W32 bs{b} graphed, ms a training microbatch "
          f"and an eval batch (host wall over 10 replays): {ms}")
    return ms


# ---------------------------------------------------------- rasterizer


def raster(kind: str) -> None:
    """The mesh rasterizer on ``procedural_hand_mesh`` at each of
    ``RENDER_SIZES``, a row each: the profiler's device ms of its kernels
    (``raster_``), its kernels a call, the twin's ms, the bound (bytes, or
    the f64 operations of the drawn faces' box pixels), and the device ms
    at each geometry."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops.kernels import rasterize
    from lighthand_tpu_torch.utils import mesh_render

    dev = torch.device("cuda")
    v, f, _ = fx.procedural_hand_mesh()
    rng = np.random.default_rng(8)
    faces = torch.from_numpy(f).to(dev)
    for w, h, focal in fx.RENDER_SIZES:
        px, z = mesh_render.project_points(
            v, np.zeros(3), np.array([0.01, -0.02, 2.0]), [focal, focal],
            [w / 2, h / 2], dev)
        shaded = mesh_render.Renderer(w, h, faces=f, device=dev)._shade(
            v, f, [0.65098039, 0.74117647, 0.85882353])
        image = torch.from_numpy(rng.uniform(0, 1, (h, w, 3))).to(dev)
        far = abs(2.0 - float(np.mean(v, axis=0)[2])) + 20.0
        args = (px, z, faces, shaded, image, 1.0, far)

        def call(**kw):
            return rasterize.rasterize_mesh_cuda(*args, **kw)
        nan = torch.full_like(image, float("nan"))
        covered = int(torch.isfinite(rasterize.rasterize_mesh_cuda(
            px, z, faces, shaded, nan, 1.0, far)).all(-1).sum())
        _, _, _, box, keep = rasterize._face_setup(px, z, faces, h, w, 1.0,
                                                   far)
        box_px = int(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2]))
                     [keep].sum())
        dev_ms, per_call = kernel_ms(call, ("raster_",))
        by_geometry = {name: kernel_ms(
            lambda: call(geometry=getattr(rasterize, name)), ("raster_",))[0]
            for name in ("LARGE", "SMALL")}
        nbytes = (px.shape[0] * (2 + 1 + 3) * 8 + faces.numel() * 8
                  + 2 * image.numel() * 8)
        ops = (box_px * RASTER_OPS_PER_BOX_PIXEL
               + covered * RASTER_OPS_PER_COVERED_PIXEL)
        row("rasterizer", f"{w}x{h}, {len(f)} faces ({box_px} box pixels, "
            f"{covered} covered)", dev_ms, eager_ms(call),
            bound_ms(nbytes, ops, kind, F64), eager_ms(
                lambda: rasterize.rasterize_mesh_plain(*args), calls=3,
                warmup=1), kernels_a_call=per_call,
            geometry=rasterize.choose_geometry(
                h, w, rasterize._sm_count(dev.index or 0)),
            work=f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} Mop f64",
            **{f"{k}_device_ms": ms for k, ms in by_geometry.items()})


# ---------------------------------------------------------- beside K1


def beside_k1() -> dict:
    """Eager and device ms of the flip / rotation chain (jitter, noise,
    rotate, normalize, flip, then K2's targets) at B=128 and of the
    jittering ``DevicePreprocessor`` (bf16) at B=32, each beside K1 at the
    same batch; the profiler's kernel sum where nothing is captured."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.data import DevicePreprocessor
    from lighthand_tpu_torch.ops.color import draw_jitter
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        fused_aug_targets_cuda,
    )
    from lighthand_tpu_torch.train import make_targets
    from lighthand_tpu_torch.train.step import (
        chain_augment,
        draw_affine_params,
    )

    dev, b = torch.device("cuda"), fx.B_TRAIN
    images, joints, params = fx.k1_inputs(fx.B_KERNEL, 1)
    mask, deg = draw_affine_params(torch.Generator(device=dev).manual_seed(3),
                                   fx.B_KERNEL, True, 15.0)

    def chain():
        img, moved = chain_augment(images, joints, params, mask, deg)
        return img, make_targets(moved)

    rng = np.random.default_rng(31)
    u8 = torch.from_numpy(rng.integers(0, 256, size=(b, fx.SIZE, fx.SIZE, 3),
                                       dtype=np.uint8)).to(dev)
    aug = torch.from_numpy((np.arange(b) % 4 != 3).astype(np.float32)).to(dev)
    factors, _ = draw_jitter(torch.Generator().manual_seed(32), b)
    perms = list(itertools.permutations(range(4)))
    order = torch.tensor([perms[i % 24] for i in range(b)], device=dev)
    pre, factors = DevicePreprocessor(device=dev), factors.to(dev)
    k1_small = fx.k1_inputs(b, 34)
    out = {}
    for name, fn, graphed in (
            ("chain B=128", chain, False),
            ("K1 B=128", lambda: fused_aug_targets_cuda(images, joints,
                                                        params), True),
            ("DevicePreprocessor B=32", lambda: pre(
                u8, aug, factors=factors, order=order), False),
            ("K1 B=32", lambda: fused_aug_targets_cuda(*k1_small), True)):
        dev_ms, how = device_ms(fn, capture(fn) if graphed else None)
        out[name] = {"eager_ms": eager_ms(fn), "device_ms": dev_ms}
        print(f"[beside K1] {name} 256x256 bf16: eager "
              f"{out[name]['eager_ms']:.4f} ms, device {dev_ms:.4f} ms "
              f"({how})")
    return out


def host() -> dict:
    """Host ms a call, one thread: the codec's 224x224 4:2:0 q95 JPEG
    decode, its resize to 256 and its warp to 224, and a JPEG encode at
    quality 95 (mean of 200); one ``draw_text`` caption on a 256x256
    image, three rows (median of 20 single calls)."""
    import numpy as np

    from lighthand_tpu_torch.data import imageio
    from lighthand_tpu_torch.utils import vis3d

    ref = next(e for e in fx.load_manifest()
               if e["file"] == "hand_420_q95.jpg")
    with open(ref["path"], "rb") as f:
        data = f.read()
    img, mat = imageio.imdecode_rgb(data), np.asarray(ref["warp"])
    calls = {"decode_224_jpeg": lambda: imageio.imdecode_rgb(data),
             "resize_224_to_256": lambda: imageio.resize_linear(img, 256),
             "warp_224": lambda: imageio.warp_affine_inverse(img, mat,
                                                             (224, 224)),
             "encode_224_q95": lambda: imageio.encode_jpeg_rgb(img, 95)}
    times = {k: host_us(fn, calls=200) / 1e3 for k, fn in calls.items()}
    canvas = np.random.default_rng(7).uniform(0, 1, (256, 256, 3))
    content = {"pck": 0.8812, "auc": 0.5, "epoch": 3}
    times["draw_text"] = float(np.median(
        [host_us(lambda: vis3d.draw_text(canvas, content), calls=1) / 1e3
         for _ in range(20)]))
    print(f"[host] ms a call, one thread ({len(os.sched_getaffinity(0))} "
          f"cores, load {' '.join(f'{x:.2f}' for x in os.getloadavg())}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose lighthand_tpu_torch to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_breakdown: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    from lighthand_tpu_torch.ops.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    root = args.root or "."
    print(f"{smi.splitlines()[0] if smi else kind}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}; kernels of {root}")
    for name, log in sorted(_build.build_all().items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    result = {"root": root, "device": kind, "smi": smi,
              "sass": sass_counts(str(_build.library_path("fused_aug")))}
    print(f"[sass] K1 library [instructions, MUFU.RCP]: {result['sass']}")
    result["mixes"] = targets(kind)
    result["int8_forward"] = int8(kind)
    result["forwards"] = forwards()
    result["bn_microbatch"] = batch_norm(kind)
    result["bn_routes"] = bn_routes()
    raster(kind)
    result["beside_k1"] = beside_k1()
    result["host"] = host()
    result["rows"] = ROWS
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
