#!/usr/bin/env python3
"""Where the port's CUDA kernels and forwards spend their time, on one
NVIDIA GPU.

    python3 kernel_breakdown.py                 # this checkout's kernels
    python3 kernel_breakdown.py --root DIR      # the kernels of another
                                                # checkout (e.g. a parent
                                                # commit unpacked in DIR)

Times K1 (fused aug + targets) and K2 (heatmap targets) at B=32 and B=128,
256x256, with the inputs and timing of ``chip_smoke.py`` phase 7: the eager
call time (events around 20 back-to-back calls) and the device time (the
call captured in a CUDA graph and replayed 20 times). Then K1 at B=128 in
bf16 under op mixes that isolate its parts: jitter off (load, noise,
normalize, store, targets), each op four times in every sample, every
sample jittered with the 24 op orders, and the smoke's mix. It prints the
ptxas report and, where ``cuobjdump`` is found, K1's SASS instruction and
division (MUFU.RCP) counts. Then the eval forward of ResNet-50 and
HRNet-W32 at bs32, 256x256, under bf16 and int8_fwd (the same random
weights): CUDA events around 5 blocks of 4 forwards after 3 warm-ups, the
host ms a forward of 4 unsynchronised calls, and the profiler's device
ms and kernel count a forward over 3, with the int8 weight quantize's
share (every kernel whose name holds ``quantize_weight``). Then the int8
conv at both models' Cin-3 stems (bs32, 256x256, bf16 in and out; device
ms in a replayed CUDA graph, with the plan's path) and the mesh
rasterizer on ``chip_smoke.procedural_hand_mesh`` at 800x600 and 224x224
(the profiler's device ms and kernels a call, whichever kernels the
checkout has; where its wrapper chooses a geometry, the device ms at each).
With ``--root`` run parent, change, change, parent in one
call to compare two commits.
The last line is one JSON object with every number. Without a card it
exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import chip_smoke as cs

MIXES = {  # name: (enable, op order or None for the 24 orders)
    "jitter off": (0.0, None),
    "brightness x4": (1.0, [0, 0, 0, 0]),
    "saturation x4": (1.0, [2, 2, 2, 2]),
    "hue x4": (1.0, [3, 3, 3, 3]),
    "contrast x4": (1.0, [1, 1, 1, 1]),
    "24 orders, all jittered": (1.0, None),
}


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


def forwards() -> dict:
    """{"model policy": figures} of the eval forwards (see the module
    docstring), from whichever ``lighthand_tpu_torch`` is on the path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import init_weights

    x = torch.randn(cs.B_TRAIN, 3, cs.SIZE, cs.SIZE, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    out = {}
    for name in ("resnet50", "hrnet_w32"):
        for tag, policy in (("bf16", DTypePolicy()),
                            ("int8_fwd", DTypePolicy.int8_fwd())):
            model = get_model(name, policy=policy)
            init_weights(model, torch.Generator().manual_seed(0))
            model = model.eval().to("cuda", memory_format=torch.channels_last)
            with torch.no_grad():
                blocks = sorted(cs.eager_ms(lambda: model(x), calls=4,
                                            warmup=3) for _ in range(5))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    model(x)
                host = (time.perf_counter() - t0) / 4 * 1e3
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        model(x)
                    torch.cuda.synchronize()
            kernels = [(e.self_device_time_total / 3e3, e.count // 3, e.key)
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0]
            quant = [k for k in kernels if "quantize_weight" in k[2]]
            fig = {"ms": blocks, "host_ms": host,
                   "kernel_ms": sum(k[0] for k in kernels),
                   "kernels": sum(k[1] for k in kernels),
                   "quantize_ms": sum(k[0] for k in quant),
                   "quantize_launches": sum(k[1] for k in quant)}
            out[f"{name} {tag}"] = fig
            print(f"[forward] {name} {tag} bs{cs.B_TRAIN}: ms a forward "
                  f"(5 blocks of 4) {[round(t, 3) for t in blocks]}, host "
                  f"{host:.3f} ms, kernels {fig['kernel_ms']:.3f} ms x"
                  f"{fig['kernels']}, weight quantize "
                  f"{fig['quantize_ms']:.4f} ms x{fig['quantize_launches']}")
            del model
    return out


STEMS = {"resnet50": (3, 256, 256, 64, 7, 2),
         "hrnet_w32": (3, 256, 256, 64, 3, 2)}
# the rasterizer's kernels, before and since its redesign
RASTER_KERNELS = ("init_kernel", "depth_pass", "shade_kernel", "raster_")


def stems_and_raster() -> dict:
    """{"stems": {model: figures}, "raster": {size: figures}} of whichever
    ``lighthand_tpu_torch`` is on the path (see the module docstring)."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        quantize_weight_cuda,
    )
    from lighthand_tpu_torch.ops.kernels import rasterize
    from lighthand_tpu_torch.ops.kernels.rasterize import rasterize_mesh_cuda
    from lighthand_tpu_torch.utils import mesh_render

    out = {"stems": {}, "raster": {}}
    for name, shape in STEMS.items():
        x, wt = cs.int8_inputs(cs.B_TRAIN, shape, 3)
        w_q, _, scale = quantize_weight_cuda(wt, cs.ACT_CLIP)
        k, stride = shape[4], shape[5]

        def conv():
            return int8_conv2d_cuda(x, w_q, scale, cs.ACT_CLIP, stride, k // 2)
        dev_ms, _ = cs.device_ms(conv, cs.capture(conv))
        path = conv_plan(x, w_q, stride, k // 2)["path"]
        out["stems"][name] = {"device_ms": dev_ms, "path": path}
        print(f"[stem] {name} {shape} bs{cs.B_TRAIN}: device {dev_ms:.4f} ms "
              f"({path} path)")
    v, f, colors = cs.procedural_hand_mesh()
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    for w, h, focal in cs.RENDER_SIZES:
        px, z = mesh_render.project_points(
            v, np.zeros(3), np.array([0.01, -0.02, 2.0]), [focal, focal],
            [w / 2, h / 2], dev)
        args = (px, z, torch.from_numpy(f).to(dev),
                torch.from_numpy(colors).to(dev),
                torch.from_numpy(rng.uniform(0, 1, (h, w, 3))).to(dev), 1.0,
                abs(2.0 - float(np.mean(v, axis=0)[2])) + 20.0)
        dev_ms, per_call = cs._kernel_device_ms(
            lambda: rasterize_mesh_cuda(*args), RASTER_KERNELS)
        fig = {"device_ms": dev_ms, "kernels_a_call": per_call}
        # each geometry of a checkout whose wrapper chooses one
        for name in ("LARGE", "SMALL"):
            geometry = getattr(rasterize, name, None)
            if geometry is not None:
                fig[name], _ = cs._kernel_device_ms(
                    lambda: rasterize_mesh_cuda(*args, geometry=geometry),
                    RASTER_KERNELS)
        out["raster"][f"{w}x{h}"] = fig
        print(f"[raster] {w}x{h}, {len(f)} faces: device {dev_ms:.4f} ms, "
              f"{per_call:g} kernels a call; by geometry "
              f"{ {k: v for k, v in fig.items() if k.isupper()} }")
    return out


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
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        fused_aug_targets_cuda,
    )
    from lighthand_tpu_torch.ops.kernels.heatmap import (
        generate_target_batch_cuda,
    )

    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    root = args.root or "."
    print(f"{smi.splitlines()[0] if smi else kind}; kernels of {root}")
    for name, log in sorted(_build.build_all().items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    result = {"root": root, "device": kind, "smi": smi, "times": {},
              "mixes": {},
              "sass": sass_counts(str(_build.library_path("fused_aug")))}
    print(f"[sass] K1 library [instructions, MUFU.RCP]: {result['sass']}")

    def times(fn):
        eager = cs.eager_ms(fn)
        dev_ms, how = cs.device_ms(fn, cs.capture(fn))
        return eager, dev_ms, how

    for b, seed in ((cs.B_TRAIN, 2), (cs.B_KERNEL, 1)):
        images, joints, params = cs.k1_inputs(b, seed)
        for name, fn in (
                ("fused_aug_targets",
                 lambda: fused_aug_targets_cuda(images, joints, params)),
                ("heatmap_targets",
                 lambda: generate_target_batch_cuda(joints))):
            eager, dev_ms, how = times(fn)
            result["times"][f"{name} B={b}"] = {"eager_ms": eager,
                                                "device_ms": dev_ms,
                                                "how": how}
            print(f"[{name}] B={b}: eager {eager:.4f} ms/call, device "
                  f"{dev_ms:.4f} ms ({how})")
        if b == cs.B_KERNEL:
            for mix, (enable, order) in MIXES.items():
                p = params.clone()
                p[:, 0] = enable
                if order is not None:
                    p[:, 5:9] = torch.tensor(order, dtype=torch.float32,
                                             device=p.device)
                _, dev_ms, how = times(
                    lambda: fused_aug_targets_cuda(images, joints, p))
                result["mixes"][mix] = dev_ms
                print(f"[K1 mix] B={b} {mix}: device {dev_ms:.4f} ms ({how})")
            result["mixes"]["smoke mix"] = \
                result["times"][f"fused_aug_targets B={b}"]["device_ms"]
    result["forwards"] = forwards()
    result.update(stems_and_raster())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
