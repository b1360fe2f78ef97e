#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lighthand_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises, exits nonzero and prints no ok line):

1. device and build: the card's name and power limit (nvidia-smi), then
   the three CUDA libraries built from ``lighthand_tpu_torch/csrc`` with nvcc and
   the host libraries of the data readers (the image codec, the TSV
   engine) with the host C++ compiler, all at once;
1b. the codec: every committed fixture image (``tests/fixtures/images``)
   decoded, gray-decoded, resized to 256 and warped to 224 by the port's
   codec, each equal to the SHA-256 of cv2's result stored beside it (this
   machine has no cv2 for the port to lean on); the host ms of a 224x224
   JPEG decode, of its resize to 256 and of its warp;
2. K2 (heatmap targets) against its plain twin, B=128 and B=32, atol 1e-5,
   and one ragged case: B=5, hm=50 (scalar stores), stride 3.0, joints a
   [B, J, 3] tensor read through its strides;
3. K1's division in normalize (reciprocal and one correction) against IEEE
   division for every numerator it can get, which must give 0 mismatches;
   K1 (fused aug + targets) against its plain twin at B=128 and B=32,
   256x256: targets within 1e-5; the f32 variant within 1e-5 (the mean of
   each image is summed in another order); the bf16 image equal on
   >= 99.9 % of elements and within max(1 bf16 ulp of the value, 1e-5)
   everywhere: below |value| = 2^-10 a bf16 ulp is finer than the f32
   agreement of the two computations. Ragged cases under the same
   tolerances: B=3 at 97x131 (unaligned rows, masked tails), hm=50,
   stride 3.0, [B, J, 3] joints and op indices outside [0, 3] (clamped,
   contrast in two slots); B=2 at 300x300 (16 blocks of 704 threads, one
   block to an SM, where 256x256 runs 16 blocks of 512); B=2 at 16x16
   with 40 joints (one block quantising more maps than it keeps in shared
   memory); and B=2 at 384x384 and at 517x771, above the 131,072 pixels
   the register kernel holds (its threads then walk 2 and 4 groups of 8
   pixels);
2b. both int8 kernels (``csrc/int8_conv.cu``) against their plain twins,
   bit for bit (0 differing values): the weight quantize (w_q, s_w,
   scale) from f32 master weights with an all-zero channel, then the conv
   on bf16 and f32 activations (with x * inv = k + 0.5 ties, values beyond
   the clip and zeros) into bf16 and f32 output: every distinct quantized
   conv shape of ResNet-50 (53 convs) and HRNet-W32 (292), read by hooks,
   at batch 32, 256x256, and the ragged cases of ``INT8_RAGGED`` (the
   stem path at N=1 and 3, odd sizes, Cout 40, 100 and 200 at Cin 3 and 5,
   Cin 8 and 48, pad 0 and 3, an x 2 or 4 bytes off 16-byte alignment; the
   simple path at K = 432 and for a main-path shape whose x is off; the
   main path at Cout 40 and 100 and 32-channel chunks), each on the path
   it must take, both models' stems on the stem path and the simple path
   reached; the twin runs on the card with cuDNN off (im2col + DGEMM,
   exact on integers); then the
   grouped weight quantize (``quantize_weights_cuda``, one launch for a
   list of weights) against ``quantize_weights_plain``, bit for bit, over
   all 292 HRNet-W32 and all 53 ResNet-50 weights in one group each, in
   both layouts, and ragged groups (the K = 27 and 147 stems, Cout 40 and
   33, rows of 45 and 20 values, all-zero channels, a source off 16-byte
   alignment, every other output or input channel of a weight, rows
   beyond a stage buffer, a group of one), each w_q at a 128-byte offset;
2c. a ``QuantConv2d`` on the card equals the same module on the CPU, bit
   for bit, at ResNet-50's and HRNet-W32's heaviest shapes, bf16 and f32:
   the weight scale divides on both devices;
4. the main path, train: HRNet-W32 at 256x256, batch 32, bf16 policy,
   ``make_fused_train_step`` for 3 steps; K1 must launch 3 times and every
   loss be finite;
5. the main path, eval: ``make_eval_step`` twice on a batch of 32 whose last
   4 rows are padding (n_valid must be 28, K2 must launch), then
   ``make_predict_step`` once;
4b. int8 training: HRNet-W32, ``DTypePolicy.int8_fwd()``, 3 fused steps:
   finite losses, K1 3 launches, the int8 conv 3 x 292 and the grouped
   weight quantize 3 (one a forward);
5b. int8 serving: phase 4's W32 weights predicted under bf16 and under
   int8_fwd (``load_state_dict``), the share of joints within 1 heatmap px
   of each other printed; 292 int8 conv launches and 1 weight quantize;
4c. the flip / rotation route: HRNet-W32, 256x256, bs32, bf16,
   ``make_fused_train_step(flip=True, rot_deg=15.0)`` for 3 steps: finite
   losses, K1 0 and K2 3 launches; the chain (jitter, noise, rotate,
   normalize, flip) on the card against the same chain on the CPU with the
   same draws (the CPU tests' tolerances: images 3e-4, joints 1e-4 px, K2's
   targets 1e-5); the chain without flip or rotation on K1's draws against
   K1 under phase 3's tolerances; the chain's time at B=128 beside K1's and
   the step's beside phase 4's;
6. the training entry point: ``lighthand_tpu_torch.cli.train.main`` in a
   temporary directory, SimpleBaseline ResNet-50 at 256x256, batch 32, bf16,
   synthetic data (128 train samples, 32 val), 3 microbatches a dispatch:
   run A trains 2 epochs from scratch (``--reset``), run B resumes with 3
   epochs at the best epoch + 1. Each epoch is one K=3 dispatch, a ragged
   K=1 tail step and one eval batch, so K1 must launch 4 times and K2 once
   for every epoch run. Both runs must print the ``done:`` line, write
   finite Loss/train and Loss/valid for every epoch run, the checkpoint and
   ``last_checkpoint.json`` with the model's name and precision, and run B
   must start at run A's best epoch + 1. Per-epoch wall time, epoch img/s
   and the device time of the steady K=3 dispatches are printed (a smoke
   figure, not a benchmark);
6b. the real-data path: the same CLI on a LightHand99K tree written into
   a temporary directory (128 train, 32 eval records pointing at the
   fixture JPEGs), without ``--synthetic``, 2 epochs: the done line,
   finite losses for both epochs, K1 4 and K2 1 launches an epoch, the
   decoded-crop cache's hit fraction 1.0 in epoch 2 (read from the log),
   and the cached rows epoch 2 read equal to a fresh decode; epoch wall
   seconds and img/s printed beside phase 6's synthetic ones;
6c. a FreiHAND TSV tree of the fixture bytes through the Loader into one
   fused step (TSV engine, base64, decode, inverse-map warp, noise rows),
   then one ``per_sample`` fused step on a GAN + LightHand mix (max-combine
   targets where ``hm_max`` is set); K1 must launch twice;
6d. the eval entry point: ``lighthand_tpu_torch.cli.eval.main`` on 6b's run
   (SimpleBaseline ResNet-50, bf16 checkpoint) over an Armo tree of the
   fixture JPEGs (64 records, 16 a category, some joints hidden, 2 short
   records dropped), with the checkpoint's precision, with ``--precision
   int8_fwd`` and with ``--test``: exit 0, evaluation.json's categories and
   counts, three pck_eval files of 5 rows (finite AUC, EPE, 100 PCK values),
   the --test AUC lines, under int8_fwd 53 int8 conv launches and 1 weight
   quantize a batch (106 and 2) and none otherwise; img/s of each run;
6e. the training CLI with ``--flip --rot-aug 15`` (SimpleBaseline
   ResNet-50, synthetic, 64 train and 32 val samples, bs32, 1 epoch): the
   done line, finite losses, K1 0 and K2 3 launches, the route logged once;
6f. the distributed path at world size 1: ``cli.train`` in a subprocess
   under the environment contract (``LIGHTHAND_COORDINATOR`` on a free
   local port, 1 process, ``--mesh-data 1 --mesh-model 1``) against a plain
   subprocess run of the same seed (ResNet-50, f32, 1 epoch; the child sets
   no TF32 switch, so both runs take the f32 policy's own): the NCCL
   backend and the replicated model (the run's log line: at model axis 1
   nothing is sharded, as in the JAX package), Loss/train and Loss/valid
   within 5e-3 relative, and ``cli.eval`` on the checkpoint rank 0 wrote
   (32 Armo records); then phase 4's steady step, plain and on a 1 x 1 mesh
   (plain, ``channels_last`` parameters, no FSDP wrap), in one NCCL
   process: the mesh step within 10 % of the plain one, with Adam alone
   (``train/state.py:ShardAdam``) and the profiler's top operations and
   ranges of both steps. Meshes above one process are rehearsed only on
   the CPU (``tests/test_torch_dist.py``);
9a. ``python -m lighthand_tpu_torch.cli.make_synth_data`` with
   ``SYNTH_ARGS`` (64 train, 32 eval, 32 Armo, 16 FreiHAND TSV): every
   file's SHA-256 equal to the digests of the JAX CLI's tree
   (``tests/fixtures/make_synth_digests.json``, which a CPU test checks;
   this machine's cv2 may differ and is not used); host img/s;
9b. host ms of one 224x224 RGB JPEG encode at quality 95 and of one
   decode, beside phase 1b's;
9c. ``cli.train`` (SimpleBaseline ResNet-50, bs32, bf16, 1 epoch) on 9a's
   LightHand tree with overlays on: the train overlays at iterations 0 and
   1 and the val overlay at 0, each decoding to 256x512x3; K1 2 and K2 1
   launches; the epoch's seconds and host ms per overlay;
9d. ``cli.eval --plt --plt_max 8`` on 9a's Armo tree with 9c's
   checkpoint: exactly 8 overlays, all 32 rows in evaluation.json;
9e. ``python -m lighthand_tpu_torch.cli.make_lighthand`` over
   ``write_armhand_tree``'s capture tree: digests equal to the JAX CLI's;
9f. ``ops/geometry.py`` and ``ops/procrustes.py`` on CUDA tensors against
   the CPU, within the CPU tests' tolerances;
9g. the landmark and skeleton overlays (``utils/landmarks.py``,
   ``utils/vis3d.py``: thick lines, outline circles, arrows, JPEG files)
   drawn on the host, every drawing equal to the stored digests of the JAX
   package's cv2 5.0.0 drawings (``tests/fixtures/overlay_digests.json``);
   the ``.png`` route decoding to its pixels; a line saying that the two
   Matplotlib figure functions are tested on the CPU only;
9h. the mesh renderer: the rasterizer kernel (``csrc/rasterize.cu``)
   against its plain twin on the card, bit for bit, at 800x600 and
   224x224 on a MANO-sized procedural mesh with coplanar duplicate faces,
   and on ``raster_edge_cases`` at both of the wrapper's geometries (a tile
   meeting more faces than its list holds, a face larger than a tile,
   faces off the image, 1x1 and 17x13 images); at most 2 kernels a call
   and no allocation a pixel but the image;
   ``Renderer.render`` and ``render_vertex_color`` end to end on the card
   (one rasterizer launch each) against the CPU; the kernel's times beside
   the twin's and its bound (the ``rasterize`` row of the kernels line);
10a. fine-tuning and scoring: phase 4's trained HRNet-W32 (256x256, bs32,
   bf16) in a state whose stem and ``layer1`` are frozen
   (``freeze_mask``, ``create_train_state(trainable=...)``), 3 fused
   steps (K1 3 launches): frozen parameters bit-equal with no gradient,
   every trainable one moved, ``param_count`` unchanged; then the predict
   step (its joints are its heatmaps' argmax), and the heatmaps scored on
   the card and on the CPU: ``get_max_preds``, ``pck_2d`` (proportion and
   mm), ``pck_2d_visible``, ``pck_curve`` over the offline eval's pckb and
   mm grids and ``pck_3d`` on a lifted, jittered copy of the joints all
   equal, ``soft_argmax_preds`` within 1e-4 px, the keypoint losses within
   1e-5 relative; the steps' ms and the scores printed;
10b. single-sample targets: ``generate_target`` on CUDA joints at J=21,
   H=64, stride 4, and at H=50, stride 3.0 with [J, 3] joints and one
   joint off the map: one K2 launch a call, maps within 1e-5 of the plain
   twin on the card and of the CPU, weights equal to the CPU's;
10c. the jittering preprocessor: ``DevicePreprocessor(jitter=True)`` on a
   u8 bs32 256x256 batch on the card and on the CPU with the same
   injected draws (every op order), f32 out, within 3e-4 in normalised
   units (the chain's bound, phase 4c); no kernel launched; its device ms
   (the profiler's kernel sum) beside K1's at the same batch;
7. reference: the trained W32 in f32 on the card against the same
   weights on the CPU at 64x64, atol 2e-4 / rtol 1e-3 (the tolerances the
   CPU tests hold the port's CPU forward to against JAX), with both TF32
   switches set True beforehand and only the f32 policy's
   ``core/dtypes.py:numerics`` around the forward: it fails if that
   context does not make the convs full f32;
8. kernel times beside their plain twins' and their bounds, at the main
   path's batch (32) and at the bench's (128): the eager call time (CUDA
   events around 20 back-to-back calls, over 20) and the device time (the
   call captured once in a CUDA graph and replayed 20 times between two
   events, or the profiler's kernel time where capture refuses it); at
   B=32, whose ~30 MB fit in the 50 MB L2, both again with the L2 flushed
   by a 128 MB write before each call. The B=128 figures make the
   ``{"kernels": ...}`` JSON line, whose ``launches`` add up the launches of
   phases 4-5, 4b, 5b, 4c, 6, 6b, 6c, 6d, 6e, 6f, 9c, 9d, 10a and 10b (each
   also under ``launches_by_path``; each path's counts are zeroed just
   before it and read just after); the rasterizer's row is phase 9h's, its
   launches those of 9h's renders;
8b. both int8 kernels at the heaviest conv shape (by operations a
   forward) of ResNet-50 and of HRNet-W32, and at each model's Cin-3 stem
   (the stem path; the ``stems`` of the ``int8_conv`` row), batch 32, bf16
   activations:
   eager and device time, the twin's time and the bound (int8 tensor-core
   operations or bytes, bf16 in and out, for the conv; 5 bytes a weight
   for the weight quantize, here a group of one); for the conv, the GEMM
   of ``torch._int_mm`` on the pre-quantized im2col of the same operands,
   K zero-padded to a multiple of 8 (checked equal to the kernel), and
   cuDNN's bf16 conv of the shape; the
   shape with more operations a call makes the kernels line's
   ``int8_conv`` row;
8c. the eval forward of ResNet-50 and HRNet-W32 at bs32 under bf16 and
   int8_fwd, with the profiler's device time by kernel, the device's busy
   share of it and its count of device kernels a forward, which must not
   be larger under int8_fwd than under bf16;
8d. the grouped weight quantize over each whole model's weights (292 of
   W32, 53 of ResNet-50): eager ms, device ms in a replayed CUDA graph,
   its byte bound, the twin's ms and the host us a call, beside the same
   weights quantized a launch a conv (eager and device ms); the grouped
   launch over W32's weights makes the kernels line's ``quantize_weight``
   row. Then the quantized convs of a forward, every distinct shape of
   both nets at bs32 weighted by its uses: device ms of the conv alone
   (plus the grouped launch: a forward's quantized convs) and with a
   quantize a conv, each shape's plan, and the host us a call of
   ``quant_forward`` (its weights quantized already, and quantizing its
   own) beside a bf16 conv with its weight cast.
   The last line is the ok line.

TF32: phases 1 to 10 run with torch's defaults (``cudnn.allow_tf32`` True,
``cuda.matmul.allow_tf32`` False), as a user's process does: the entry
points' f32 runs set their own full f32 (``core/dtypes.py:numerics``), and
no other phase compares an f32 convolution; the main path's convolutions
are bf16, which TF32 does not touch. Phase 7 sets both True and relies on
the policy's context. Phases 8 to 8d, which only time kernels, run with
both False.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

# Published peaks (NVIDIA data sheets, dense): memory bytes/s, f32
# (non-tensor-core) operations/s, int8 tensor-core operations/s and f64
# (non-tensor-core) operations/s, keyed by a substring of the card's name.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 1513e12, 26e12),
    "H100 NVL": (3.9e12, 60e12, 1671e12, 30e12),
    "H100": (3.35e12, 67e12, 1979e12, 34e12),  # SXM
}
# f32 operations per pixel of K1's function: u8/255 (3), brightness (9),
# contrast incl. its gray mean (21), saturation (20), hue (~42), the
# enable gate (9), channel noise (9), normalize (6).
K1_OPS_PER_PIXEL = 119
TARGET_OPS_PER_ELEMENT = 10  # 2 sub, 2 abs+cmp, 2 mul, add, mul, exp
# f32 operations per weight of the weight quantize: |w| and its max, then
# the division, the rounding and the two-sided clamp.
WEIGHT_OPS_PER_VALUE = 6

B_KERNEL, B_TRAIN, SIZE, JOINTS, HM = 128, 32, 256, 21, 64
F32_ATOL = 1e-5
ACT_CLIP = 8.0  # the int8_fwd policy's static activation clip


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return val
    print(f"note: no peak table entry for {name!r}; using H100 SXM's")
    return PEAKS["H100"]


def bound_ms(nbytes: float, ops: float, name: str, int8: bool = False,
             f64: bool = False):
    """The least time for the work: bytes over the memory rate or the
    operations over the peak rate of their type (f32, int8 tensor-core
    or f64 operations), whichever is larger."""
    bw, flops, int8_ops, f64_ops = peaks(name)
    rate = int8_ops if int8 else f64_ops if f64 else flops
    t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def device_ms(fn, graph, calls: int = 20):
    """(ms per call on the device, how it was measured): graph replays
    between two events, or the profiler's summed kernel time."""
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / calls, "profiler"


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


def bf16_ulp(x):
    import torch

    a = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def k1_inputs(b: int, seed: int, h: int = SIZE, w: int = SIZE,
              cols: int = 2, order=None, njoints: int = JOINTS,
              device="cuda"):
    """u8 images, joints and packed draws: the first half of the batch (its
    larger half) has
    jitter on, every 4th sample noise on, and sample i takes the i-th of
    the 24 op orders (or row i of ``order``), so every op sits in every
    slot (hue before contrast included) among the jittered samples."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    joints = rng.uniform(-40, max(h, w) + 40, size=(b, njoints, cols))
    perms = list(itertools.permutations(range(4)))
    if order is None:
        order = [perms[i % 24] for i in range(b)]
    order = np.array(order, np.float32)
    aug = (np.arange(b) < (b + 1) // 2).astype(np.float32)
    noise = (np.arange(b) % 4 == 1).astype(np.float32)
    pn = rng.uniform(0.6, 1.4, (b, 3)) * noise[:, None] + (1 - noise[:, None])
    params = np.concatenate([aug[:, None], rng.uniform(0.5, 1.5, (b, 3)),
                             rng.uniform(-0.5, 0.5, (b, 1)), order, pn], 1)
    dev = torch.device(device)
    return (torch.from_numpy(images).to(dev),
            torch.from_numpy(joints.astype(np.float32)).to(dev),
            torch.from_numpy(params.astype(np.float32)).to(dev))


REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "images")


def load_manifest() -> list:
    """The committed fixture images (``tests/fixtures/images``): file,
    kind, joints and the SHA-256 of cv2's decode, gray decode, resize to
    256 and warp to 224 (``tests/fixtures/make_images.py``)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        images = json.load(f)["images"]
    for e in images:
        e["path"] = os.path.join(FIXTURES, e["file"])
    return images


def _square_jpegs(size: int = 224) -> list:
    return [e for e in load_manifest()
            if e["kind"] == "jpeg" and e["shape"][:2] == [size, size]]


def write_lighthand_tree(root: str, n_train: int, n_eval: int) -> None:
    """A LightHand99K tree: ``{root}/LightHand/annotations/{phase}/
    CISLAB_{phase}_data.json`` whose records point at the 224x224 fixture
    JPEGs (in turn) and carry their joints (224-px space, as stored)."""
    jpegs = _square_jpegs()
    for phase, n in (("train", n_train), ("eval", n_eval)):
        d = os.path.join(root, "LightHand", "annotations", phase)
        os.makedirs(d, exist_ok=True)
        recs = [{"file_name": jpegs[i % len(jpegs)]["path"],
                 "joint_2d": jpegs[i % len(jpegs)]["joints"]}
                for i in range(n)]
        with open(os.path.join(d, f"CISLAB_{phase}_data.json"), "w") as f:
            json.dump(recs, f)


def write_freihand_tree(directory: str, n: int) -> str:
    """A FreiHAND TSV tree of ``n`` rows from the fixture JPEG bytes
    (base64 in the image TSV, center/scale/2d joints in the label TSV);
    returns the yaml descriptor's path."""
    import base64

    from lighthand_tpu_torch.data.tsv import tsv_writer

    jpegs = _square_jpegs()
    img_rows, label_rows, hw_rows = [], [], []
    for i in range(n):
        e = jpegs[i % len(jpegs)]
        with open(e["path"], "rb") as f:
            b64 = base64.b64encode(f.read()).decode("ascii")
        key = f"{i:05d}"
        img_rows.append([key, b64])
        label_rows.append([key, json.dumps([{
            "center": [112.0 + i % 5, 112.0 - i % 3],
            "scale": 0.9 + 0.05 * (i % 4), "2d_joints": e["joints"]}])])
        hw_rows.append([key, json.dumps([{"height": 224, "width": 224}])])
    os.makedirs(directory, exist_ok=True)
    for name, rows in (("img", img_rows), ("label", label_rows),
                       ("hw", hw_rows)):
        tsv_writer(rows, os.path.join(directory, f"train.{name}.tsv"))
    path = os.path.join(directory, "train.yaml")
    with open(path, "w") as f:
        f.write("img: train.img.tsv\nlabel: train.label.tsv\n"
                "hw: train.hw.tsv\n")
    return path


def write_gan_tree(root: str, n: int) -> None:
    """A GANeratedHands tree of ``n`` samples from the fixture PNGs:
    ``noObject/0001/{i}_color.png`` + ``{i}_joint2D.txt``."""
    import shutil

    pngs = [e for e in load_manifest() if e["kind"] == "png"]
    d = os.path.join(root, "GANeratedHands_Release", "data", "noObject",
                     "0001")
    os.makedirs(d, exist_ok=True)
    for i in range(1, n + 1):
        e = pngs[i % len(pngs)]
        shutil.copyfile(e["path"], os.path.join(d, f"{i:04d}_color.png"))
        with open(os.path.join(d, f"{i:04d}_joint2D.txt"), "w") as f:
            f.write(",".join(f"{v:.3f}" for xy in e["joints"] for v in xy)
                    + ",")


POSE_CATEGORIES = ("Standard", "Occlusion_by_Pinky", "Occlusion_by_Thumb",
                   "Occlusion_by_Both")


def write_armo_tree(root: str, n: int, n_bad: int = 2) -> None:
    """An Armo eval tree: ``{root}/Armo_hand_dataset/rgb/{id}.jpg`` (the
    224x224 fixture JPEGs in turn) and ``annotations.json`` with ``n``
    records cycling through the four pose categories, normalized joints,
    every 5th record's last 1-3 joints not visible, then ``n_bad`` records
    with fewer than 21 coordinates, which the reader drops."""
    import shutil

    jpegs = _square_jpegs()
    rgb = os.path.join(root, "Armo_hand_dataset", "rgb")
    os.makedirs(rgb, exist_ok=True)
    annos = {}
    for i in range(n + n_bad):
        e = jpegs[i % len(jpegs)]
        shutil.copyfile(e["path"], os.path.join(rgb, f"im{i:04d}.jpg"))
        coords = [[x / 224.0, y / 224.0] for x, y in e["joints"]]
        hidden = 1 + i % 3 if i % 5 == 0 else 0
        visible = [1.0] * (21 - hidden) + [0.0] * hidden
        if i >= n:
            coords = coords[:10 + i - n]
        annos[f"k{i:04d}"] = {"coordinates": coords, "visible": visible,
                              "pose_ctgy": POSE_CATEGORIES[i % 4],
                              "image_id": f"im{i:04d}"}
    with open(os.path.join(root, "Armo_hand_dataset", "annotations.json"),
              "w") as f:
        json.dump(annos, f)


# phase 9a's make_synth_data arguments, and the digests of the tree the
# JAX package's CLI writes for them (tests/fixtures/make_digests.py)
SYNTH_ARGS = ("--n-train", "64", "--n-eval", "32", "--n-armo", "32",
              "--n-frei", "16")
DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "make_synth_digests.json")


# phase 9g's drawings: the digests of what the JAX package draws for them
# with cv2 5.0.0 (tests/fixtures/make_overlay_digests.py)
OVERLAY_DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures", "overlay_digests.json")


def array_digest(a) -> str:
    """SHA-256 of an array's shape, dtype and bytes."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape} {a.dtype} ".encode()
                          + a.tobytes()).hexdigest()


def overlay_drawings(line, circle, arrow, landmarks, vis3d,
                     out_dir: str) -> dict:
    """{name: uint8 array, or bytes of a written file} of phase 9g's
    drawings, made with ``line(img, p1, p2, color, thickness)``,
    ``circle(img, centre, radius, color, thickness)``, ``arrow(img, p1, p2,
    color, thickness)`` and the ``landmarks`` and ``vis3d`` modules given
    (the port's, or the JAX package's with cv2's primitives), from seeded
    inputs: 40 thick lines, 40 outline circles and 40 arrows each on one
    canvas (ends and centres off the image among them), the landmark
    overlay twice (the default specs; per-landmark and per-connection
    specs), the axis triad twice, and ``vis_keypoints`` on HWC and CHW
    input with its JPEG file written into ``out_dir``."""
    import numpy as np

    rng = np.random.default_rng(17)
    out = {}

    def pt():
        return tuple(int(v) for v in rng.integers(-60, 190, 2))

    for name, draw in (("lines", line), ("circles", circle),
                       ("arrows", arrow)):
        img = np.zeros((96, 128, 3), np.uint8)
        for _ in range(40):
            color = tuple(int(v) for v in rng.integers(0, 256, 3))
            thickness = int(rng.integers(1, 6))
            if name == "circles":
                draw(img, pt(), int(rng.integers(0, 40)), color, thickness)
            else:
                draw(img, pt(), pt(), color, thickness)
        out[name] = img
    spec = landmarks.DrawingSpec
    for k in range(2):
        img = rng.integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
        lms = rng.uniform(-0.1, 1.1, size=(21, 4))
        kw = {} if k == 0 else {
            "landmark_drawing_spec": {
                i: spec(color=(i, 9 * i, 255 - i), thickness=1 + i % 4,
                        circle_radius=i % 7) for i in range(21)},
            "connection_drawing_spec": {
                c: spec(color=(200, 7 * c[1], 30), thickness=1 + c[1] % 5)
                for c in landmarks.HAND_CONNECTIONS}}
        landmarks.draw_landmarks(img, lms, landmarks.HAND_CONNECTIONS, **kw)
        out[f"landmarks_{k}"] = img
        img = rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8)
        # a rotation from a unit quaternion: no trigonometry, no BLAS
        w, x, y, z = (float(v) for v in rng.normal(size=4))
        n = math.sqrt(w * w + x * x + y * y + z * z)
        w, x, y, z = w / n, x / n, y / n, z / n
        rot = np.array(
            [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
              2 * (x * z + w * y)],
             [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
              2 * (y * z - w * x)],
             [2 * (x * z - w * y), 2 * (y * z + w * x),
              1 - 2 * (x * x + y * y)]])
        landmarks.draw_axis(img, rot, np.array([0.02, -0.01, -0.5]),
                            axis_length=0.15,
                            axis_drawing_spec=spec(thickness=2 + k))
        out[f"axis_{k}"] = img
    skeleton = vis3d.hand_skeleton_21()
    for layout in ("hwc", "chw"):
        img = rng.integers(0, 256, size=(224, 224, 3), dtype=np.uint8)
        kps = rng.uniform(-10, 234, size=(21, 2))
        score = rng.uniform(0, 1, 21)
        if layout == "chw":
            img = img.transpose(2, 0, 1).astype(np.float64)
        name = f"vis_keypoints_{layout}"
        out[name] = vis3d.vis_keypoints(img, kps, score, skeleton,
                                        filename=f"{name}.jpg",
                                        save_path=out_dir)
        with open(os.path.join(out_dir, f"{name}.jpg"), "rb") as f:
            out[f"{name}.jpg"] = f.read()
    return out


def overlay_digests(drawings: dict) -> dict:
    import hashlib

    return {k: (hashlib.sha256(v).hexdigest() if isinstance(v, bytes)
                else array_digest(v)) for k, v in sorted(drawings.items())}


def write_armhand_tree(root: str, n: int = 8, seed: int = 3) -> str:
    """A raw "ArmHand" capture tree for ``cli.make_lighthand`` (as
    ``tests/test_make_lighthand.py`` builds one): camera 1 at -400 mm on z,
    focal 500, a seeded joint cloud near the axis per frame, the 224x224
    fixture JPEGs in turn as the captures; then a camera-0 record (skipped)
    and a record whose image is missing (skipped). Returns the phase."""
    import shutil

    import numpy as np

    phase = "train"
    rng = np.random.default_rng(seed)
    jpegs = _square_jpegs()
    anno = os.path.join(root, "annotations", phase)
    cam_dir = os.path.join(root, "images", phase, "Capture0", "cam1")
    os.makedirs(anno, exist_ok=True)
    os.makedirs(cam_dir, exist_ok=True)
    camera = {"0": {"focal": {"1": [500.0, 500.0]},
                    "campos": {"1": [0.0, 0.0, -400.0]},
                    "camrot": {"1": np.eye(3).tolist()}}}
    images, joints3d = [], {}
    for i in range(n + 2):
        images.append({"camera": "0" if i == n else "1", "frame_idx": i,
                       "file_name": f"Capture0/cam1/{i:05d}.jpg"})
        pts = rng.uniform(-25, 25, size=(21, 3))
        pts[:, 2] = 0.0
        joints3d[str(i)] = {"world_coord": pts.tolist()}
        if i < n:
            shutil.copyfile(jpegs[i % len(jpegs)]["path"],
                            os.path.join(cam_dir, f"{i:05d}.jpg"))
    for name, obj in (("camera", camera), ("joint_3d", {"0": joints3d}),
                      ("data", {"images": images})):
        with open(os.path.join(anno, f"CISLAB_{phase}_{name}.json"),
                  "w") as f:
            json.dump(obj, f)
    return phase


def tree_digests(root: str) -> dict:
    """{path under ``root``: SHA-256} of every file of a tree; JSON files
    are hashed with ``root`` replaced by ``{out}`` (they name paths)."""
    import hashlib

    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                data = f.read()
            if name.endswith(".json"):
                data = data.replace(root.encode(), b"{out}")
            out[os.path.relpath(path, root)] = hashlib.sha256(
                data).hexdigest()
    return dict(sorted(out.items()))


def _scalars(run_dir: str) -> list:
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _by_epoch(rows: list, tag: str) -> dict:
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def zero(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def run_cli(argv: list, counters, tag: str, entry: str = "train") -> tuple:
    """One call of the training (or eval) CLI's ``main``, every kernel's
    count zeroed just before it and read just after; its output is printed
    with ``tag``. Returns (exit code, output, wall seconds, launches)."""
    import importlib

    cli = importlib.import_module(f"lighthand_tpu_torch.cli.{entry}")
    zero(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    counts = read(counters)
    text = out.getvalue()
    print("\n".join(f"[{tag}] {line}" for line in text.splitlines()))
    return rc, text, wall, counts


def check_run(what: str, rc: int, text: str, train: dict, valid: dict,
              ran: list) -> None:
    """The done line, Loss/train and Loss/valid for exactly the epochs
    ``ran``, all finite."""
    if rc != 0 or "done: train_loss=" not in text:
        fail(f"{what} printed no done line (rc {rc})")
    if sorted(train) != ran or sorted(valid) != ran:
        fail(f"{what}: scalars for epochs {sorted(train)} / "
             f"{sorted(valid)}, expected {ran}")
    losses = list(train.values()) + list(valid.values())
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite losses {losses}")


def cli_phase(counters) -> tuple:
    """Phase 6: two runs of the training CLI; returns each kernel's launches
    over both runs, and run A's epoch wall seconds and img/s."""
    argv = ["--root", "simplebaseline/ours", "--name", "smoke", "--synthetic",
            "--batch_size", str(B_TRAIN), "--num_our", "128",
            "--steps-per-dispatch", "3", "--count", "5", "--yes"]
    run_dir = os.path.join("output", "simplebaseline", "ours", "smoke")
    launches = {name: 0 for name in counters}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        os.chdir(tmp)
        try:
            seen, best = 0, None
            for tag, extra, epochs in (("A", ["--reset"], 2), ("B", [], 3)):
                rc, text, wall, counts = run_cli(
                    argv + extra + ["--epoch", str(epochs)], counters,
                    f"cli {tag}")
                rows = _scalars(run_dir)[seen:]
                seen += len(rows)
                first = 0 if best is None else best + 1
                ran = list(range(first, epochs))
                train, valid = (_by_epoch(rows, "Loss/train"),
                                _by_epoch(rows, "Loss/valid"))
                secs = _by_epoch(rows, "perf/epoch_seconds")
                ips = _by_epoch(rows, "perf/images_per_sec")
                disp = _by_epoch(rows, "perf/dispatch_ms")
                print(f"[cli {tag}] {wall:.1f} s in main; epochs {ran}; "
                      f"epoch wall s {secs}; epoch img/s {ips}; K=3 "
                      f"dispatch device ms {disp}; launches {counts}")
                check_run(f"CLI run {tag}", rc, text, train, valid, ran)
                if f"Start_epoch: {first}" not in text:
                    fail(f"CLI run {tag} did not start at epoch {first}")
                want = {"fused_aug_targets": 4 * len(ran),
                        "heatmap_targets": len(ran), "int8_conv": 0,
                        "quantize_weight": 0}
                if counts != want:
                    fail(f"CLI run {tag}: launches {counts}, expected {want}"
                         " (K1 once per optimizer step, K2 once per eval "
                         "batch)")
                with open(os.path.join(run_dir, "last_checkpoint.json")) as f:
                    marker = json.load(f)
                if (marker.get("model") != {"name": "simplebaseline",
                                            "precision": "bf16"}
                        or not os.path.isfile(os.path.join(
                            run_dir, "checkpoint-good", "state.pt"))):
                    fail(f"CLI run {tag}: bad checkpoint marker {marker}")
                best = marker["epoch"]
                for name in launches:
                    launches[name] += counts[name]
                if tag == "A":
                    figures = {"epoch_s": secs, "img_s": ips}
                    steady = [ms for e, ms in disp.items() if e > 0]
                else:
                    steady += list(disp.values())
            print(f"[cli] steady K=3 dispatches: median "
                  f"{statistics.median(steady):.2f} ms device time "
                  f"({len(steady)} dispatches, 3 x {B_TRAIN} images each)")
        finally:
            os.chdir(cwd)
    return launches, figures


def codec_phase() -> dict:
    """Phase 1b: every fixture through the port's codec (decode, gray
    decode, resize to 256, warp to 224) against the SHA-256 of cv2's result
    stored beside it; all must be equal. Returns host ms per call of the
    224x224 4:2:0 q95 JPEG decode, its resize to 256 and its warp, one
    thread, mean of 200 calls."""
    import hashlib

    import numpy as np

    from lighthand_tpu_torch.data import imageio

    def sha(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    checked = 0
    for e in load_manifest():
        rgb = imageio.imread_rgb(e["path"])
        got = {"decode": sha(rgb), "gray": sha(imageio.imread_gray(e["path"])),
               "resize256": sha(imageio.resize_linear(rgb, 256)),
               "warp224": sha(imageio.warp_affine_inverse(
                   rgb, np.asarray(e["warp"]), (224, 224)))}
        bad = [k for k, v in got.items() if v != e["sha256"][k]]
        if bad:
            fail(f"codec: {e['file']} differs from cv2 in {bad}")
        checked += len(got)
    ref = next(e for e in load_manifest() if e["file"] == "hand_420_q95.jpg")
    with open(ref["path"], "rb") as f:
        data = f.read()
    img = imageio.imdecode_rgb(data)
    mat = np.asarray(ref["warp"])
    times = {}
    for name, fn in (("decode_224_jpeg", lambda: imageio.imdecode_rgb(data)),
                     ("resize_224_to_256",
                      lambda: imageio.resize_linear(img, 256)),
                     ("warp_224", lambda: imageio.warp_affine_inverse(
                         img, mat, (224, 224)))):
        fn()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        times[name] = (time.perf_counter() - t0) / 200 * 1e3
    print(f"[codec] {checked} results of {len(load_manifest())} fixtures "
          f"equal cv2's (bit-exact); host ms per call, one thread: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return times


def real_tree_phase(counters, tmp: str) -> tuple:
    """Phase 6b: the training CLI on a LightHand99K tree of the fixture
    JPEGs (128 train, 32 eval records), without --synthetic, 2 epochs.
    Checks the done line, finite losses for both epochs, K1 4 and K2 1
    launches an epoch, the decoded-crop cache's hit fraction 1.0 in epoch 2
    (train and eval) and that the cached rows epoch 2 read equal a fresh
    decode of the tree. Returns the launches and the epoch figures."""
    import numpy as np

    from lighthand_tpu_torch.config import parse_args
    from lighthand_tpu_torch.data.cache import cached_sources
    from lighthand_tpu_torch.data.lighthand import (
        LightHandDataset,
        LightHandValSet,
    )
    from lighthand_tpu_torch.data.registry import build_dataset

    root = os.path.join(tmp, "datasets")
    write_lighthand_tree(root, 128, 32)
    argv = ["--root", "simplebaseline/ours", "--name", "real",
            "--dataset-root", root, "--batch_size", str(B_TRAIN),
            "--num_our", "128", "--steps-per-dispatch", "3", "--count", "5",
            "--epoch", "2", "--reset", "--yes"]
    run_dir = os.path.join("output", "simplebaseline", "ours", "real")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, text, wall, counts = run_cli(argv, counters, "real")
        rows = _scalars(run_dir)
        with open(os.path.join(run_dir, "log.txt")) as f:
            log = f.read()
        cfg = parse_args(argv)
        cfg.output_dir = os.path.join(tmp, run_dir)
    finally:
        os.chdir(cwd)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    secs = _by_epoch(rows, "perf/epoch_seconds")
    ips = _by_epoch(rows, "perf/images_per_sec")
    print(f"[real] {wall:.1f} s in main; epoch wall s {secs}; epoch img/s "
          f"{ips}; launches {counts}")
    check_run("real-tree CLI", rc, text, train, valid, [0, 1])
    # K1 once per optimizer step, K2 once per eval batch, for 2 epochs
    want = {"fused_aug_targets": 2 * (128 // B_TRAIN),
            "heatmap_targets": 2 * math.ceil(32 / B_TRAIN), "int8_conv": 0,
            "quantize_weight": 0}
    if counts != want:
        fail(f"real-tree CLI: launches {counts}, expected {want}")
    hits = {(int(e), tag): float(frac) for e, tag, frac in re.findall(
        r"epoch (\d+): (\w+) cache \S+ hit_fraction ([0-9.]+)", log)}
    print(f"[real] cache hit fraction by (epoch, loader): {hits}")
    if hits.get((1, "train")) != 1.0 or hits.get((1, "valid")) != 1.0:
        fail(f"real-tree CLI: epoch 2 did not read every row from the "
             f"cache: {hits}")
    # what epoch 2 read (the cache rows) against a fresh decode of the tree
    cached = [c for src in build_dataset(cfg) for c in cached_sources(src)]
    fresh = (LightHandDataset(root, "train", num_our=128,
                              ratio_of_aug=cfg.data.ratio_of_aug),
             LightHandValSet(root))
    if len(cached) != 2:
        fail(f"real-tree CLI: expected 2 caches, found {len(cached)}")
    for c, src in zip(cached, fresh):
        if c.hit_fraction() != 1.0:
            fail("real-tree cache lost rows after the run")
        for i in range(len(src)):
            a, b = c[i], src[i]
            if not (np.array_equal(a.image, b.image)
                    and np.array_equal(a.joints, b.joints)
                    and a.aug_enabled == b.aug_enabled):
                fail(f"real-tree cache row {i} differs from a fresh decode")
    print(f"[real] the 160 cached rows epoch 2 read equal a fresh decode")
    return counts, {"epoch_s": secs, "img_s": ips}


def frei_and_mix_phase(state, counters, tmp: str) -> dict:
    """Phase 6c: a FreiHAND TSV tree of the fixture JPEG bytes read through
    the Loader (TSV engine bulk reads, base64, decode, the inverse-map
    warp; every row noise-enabled) into one fused step; then one
    ``per_sample`` fused step on a GAN + LightHand mix (max-combine targets
    where ``hm_max`` is set). Returns the launches."""
    import torch

    from lighthand_tpu_torch.data import ConcatSource, Loader
    from lighthand_tpu_torch.data.freihand import FreiHandTSVDataset
    from lighthand_tpu_torch.data.gan import GANeratedDataset
    from lighthand_tpu_torch.data.lighthand import LightHandDataset
    from lighthand_tpu_torch.train import make_fused_train_step

    zero(counters)
    gen = torch.Generator(device="cuda").manual_seed(5)
    frei = FreiHandTSVDataset(write_freihand_tree(
        os.path.join(tmp, "frei"), 48), is_train=True)
    batch = next(iter(Loader(frei, B_TRAIN, device="cuda", shuffle=True)))
    if not bool((batch["noise_enabled"] == 1).all()):
        fail("FreiHAND rows are not noise-enabled")
    state, m = make_fused_train_step()(state, gen, batch)
    frei_loss = float(m["loss"])

    root = os.path.join(tmp, "mixroot")
    write_gan_tree(root, 24)
    write_lighthand_tree(root, 24, 0)
    mix = ConcatSource(GANeratedDataset(root),
                       LightHandDataset(root, "train", num_our=24))
    batch = next(iter(Loader(mix, B_TRAIN, device="cuda", shuffle=True)))
    sel = batch["hm_max"]
    if not (0 < float(sel.sum()) < B_TRAIN):
        fail(f"the mix batch holds one style only: hm_max {sel.tolist()}")
    step = make_fused_train_step(target_style="per_sample")
    state, m = step(state, gen, batch)
    mix_loss = float(m["loss"])
    counts = read(counters)
    print(f"[frei+mix] FreiHAND TSV fused step loss {frei_loss:.6f}; "
          f"per_sample step on GAN + LightHand ({int(sel.sum())} of "
          f"{B_TRAIN} max-style) loss {mix_loss:.6f}; launches {counts}")
    if not (math.isfinite(frei_loss) and math.isfinite(mix_loss)):
        fail("non-finite loss in the FreiHAND or mix step")
    if counts != {"fused_aug_targets": 2, "heatmap_targets": 0,
                  "int8_conv": 0, "quantize_weight": 0}:
        fail(f"frei+mix launches {counts}, expected K1 twice")
    return counts

# --------------------------------------------------------------- int8 conv


def quant_conv_shapes(name: str) -> dict:
    """{(Cin, H, W, Cout, k, stride): uses} of the quantized convs of model
    ``name`` at SIZE x SIZE, read by hooks from a batch-1 forward on the
    card (before any counted path)."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import QuantConv2d

    model = get_model(name, policy=DTypePolicy.int8_fwd()).eval().to(
        "cuda", memory_format=torch.channels_last)
    shapes = {}

    def hook(mod, args):
        x = args[0]
        key = (x.shape[1], x.shape[2], x.shape[3], mod.out_channels,
               mod.kernel_size[0], mod.stride[0])
        shapes[key] = shapes.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, QuantConv2d):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, SIZE, SIZE, device="cuda").to(
            memory_format=torch.channels_last))
    return shapes


def conv_ops(n: int, shape) -> int:
    """2 N Ho Wo Cout k^2 Cin: a multiply and an add per weight and pixel."""
    cin, h, w, cout, k, s = shape
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    return 2 * n * ho * wo * cout * k * k * cin


def int8_inputs(n: int, shape, seed: int, dtype=None, device="cuda"):
    """A conv shape's operands on the card, drawn from ``seed``: activations
    ``x`` [N, Cin, H, W] (channels_last) in ``dtype`` (bf16 by default), at
    3 sigma with x * inv = k + 0.5 ties, values beyond +-act_clip and exact
    zeros planted in the first values; f32 master weights [Cout, Cin, k, k]
    (channels_last, as the models hold them on the card) with one all-zero
    output channel (the 1e-8 floor)."""
    import numpy as np
    import torch

    cin, h, w, cout, k, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, cin)) * 3).astype(np.float32)
    inv = np.float32(127.0 / ACT_CLIP)
    near = np.float32((np.arange(-127, 127) + 0.5) / inv)
    ties = near[(near * inv) - np.floor(near * inv) == 0.5]
    special = np.concatenate([ties, [ACT_CLIP, -ACT_CLIP, 8.5, -8.5, 100.0,
                                     -100.0, 4.0, -4.0, 0.0, -0.0]])
    flat = x.reshape(-1)
    flat[:min(len(special), flat.size)] = special[:flat.size]
    wt = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
    wt[min(1, cout - 1)] = 0.0
    dev = torch.device(device)
    xt = torch.from_numpy(x).to(dev).to(dtype or torch.bfloat16)
    return (xt.permute(0, 3, 1, 2),
            torch.from_numpy(wt).to(dev).contiguous(
                memory_format=torch.channels_last))


def int8_twin(x, w_q, scale, stride, pad, out_dtype):
    """The conv's plain twin on the card with cuDNN off: the float64 conv
    then goes to im2col + cuBLAS DGEMM, exact on integers (no FFT or
    Winograd)."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import int8_conv2d_plain

    with torch.backends.cudnn.flags(enabled=False):
        return int8_conv2d_plain(x, w_q, scale, ACT_CLIP, stride, pad,
                                 out_dtype)


def misaligned(x):
    """``x`` [N, C, H, W] (channels_last) copied into a channels_last view
    one element (2 bytes in bf16, 4 in f32) into a larger buffer: off every
    16-byte boundary, as a slice of a caller's buffer may be."""
    import torch

    n, c, h, w = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(n, h, w, c)
    view.copy_(x.permute(0, 2, 3, 1))
    return view.permute(0, 3, 1, 2)


# Phase 2b's ragged conv cases: (N, (Cin, H, W, Cout, k, stride), padding
# (None: k // 2), x off 16-byte alignment, the path the plan must take)
INT8_RAGGED = [
    (3, (3, 97, 131, 64, 7, 2), None, False, "stem"),   # the 7x7 stem, N=3
    (3, (3, 97, 131, 64, 3, 2), None, False, "stem"),   # the 3x3 stem, odd
    (1, (3, 33, 47, 64, 7, 2), None, False, "stem"),    # N=1, odd H and W
    (2, (3, 31, 29, 40, 7, 2), None, False, "stem"),    # Cout 40 at Cin 3
    (2, (3, 31, 29, 100, 3, 2), None, False, "stem"),   # Cout 100: BN 128
    (2, (3, 40, 40, 64, 7, 2), 0, False, "stem"),       # pad 0
    (2, (3, 19, 21, 64, 3, 1), 3, False, "stem"),       # pad 3
    (2, (3, 31, 29, 64, 7, 2), None, True, "stem"),     # x off 16 bytes
    (2, (5, 12, 10, 200, 3, 1), None, False, "stem"),   # two channel groups
    (2, (48, 33, 17, 33, 1, 2), None, False, "stem"),   # odd Cout, K = 48
    (1, (8, 9, 11, 24, 3, 2), None, False, "stem"),     # Cin 8, K = 72
    (2, (48, 20, 20, 40, 3, 1), None, False, "simple"),  # K = 432 > 256
    (2, (64, 20, 20, 64, 3, 1), None, True, "simple"),  # main shape, x off
    (3, (64, 97, 131, 40, 3, 2), None, False, "wgmma"),  # Cout 40
    (5, (32, 15, 15, 100, 3, 1), None, False, "wgmma"),  # Cin 32, Cout 100
    (2, (96, 20, 20, 48, 3, 1), None, False, "wgmma"),  # 32-channel chunks
    (3, (64, 97, 131, 64, 3, 1), None, False, "wgmma"),  # ragged tiles
]


def int8_check_phase(shapes: dict) -> tuple:
    """Phase 2b: both int8 kernels against their twins, bit for bit (0
    differing values): the weight kernel's w_q, s_w and scale, then the
    conv (from the kernel's w_q and scale) on bf16 and f32 activations, in
    bf16 and f32 output; every distinct quantized conv shape of ResNet-50
    and HRNet-W32 at batch 32, and the ragged cases of ``INT8_RAGGED``.
    Every model stem (Cin not a multiple of 32) must take the stem path,
    each ragged case its path, and the simple path must be reached.
    Returns the largest |kernel - twin| of each kernel (0 where it
    passes)."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        quantize_weight_cuda,
        quantize_weight_plain,
    )

    distinct = sorted({key for model in shapes.values() for key in model})
    cases = ([(B_TRAIN, key, None, False,
               "stem" if key[0] % 32 else "wgmma") for key in distinct]
             + INT8_RAGGED)
    err_w = err_c = 0.0
    paths = {}
    for i, (n, key, pad, off, want_path) in enumerate(cases):
        k, stride = key[4], key[5]
        pad = k // 2 if pad is None else pad
        for dtype in (torch.bfloat16, torch.float32):
            x, w = int8_inputs(n, key, 100 + i, dtype)
            if off:
                x = misaligned(x)
            got_w = quantize_weight_cuda(w, ACT_CLIP)
            want_w = quantize_weight_plain(w, ACT_CLIP)
            torch.cuda.synchronize()
            for name, a, b in zip(("w_q", "s_w", "scale"), got_w, want_w):
                if a.shape != b.shape or bool((a != b).any()):
                    fail(f"weight kernel's {name} differs from its twin at "
                         f"{key}: {int((a != b).sum())} values")
                err_w = max(err_w, float((a.float() - b.float()).abs().max()))
            w_q, _, scale = got_w
            for out_dtype in (torch.bfloat16, torch.float32):
                got = int8_conv2d_cuda(x, w_q, scale, ACT_CLIP, stride, pad,
                                       out_dtype)
                want = int8_twin(x, w_q, scale, stride, pad, out_dtype)
                torch.cuda.synchronize()
                bad = int((got != want).sum())
                if got.shape != want.shape or bad:
                    fail(f"int8 conv differs from its twin at N={n} {key} "
                         f"pad {pad}{' x off 16 B' if off else ''} {dtype}"
                         f" -> {out_dtype}: {bad} values")
                err_c = max(err_c, float((got.float() - want.float()).abs()
                                         .max()))
                plan = conv_plan(x, w_q, stride, pad, out_dtype)
                if plan["path"] != want_path:
                    fail(f"int8 conv at N={n} {key} pad {pad} {dtype} -> "
                         f"{out_dtype} took {plan}, not the {want_path} "
                         "path")
                paths[plan["path"]] = paths.get(plan["path"], 0) + 1
            del x, w, got_w, want_w, got, want
    if not paths.get("simple"):
        fail(f"no case reached the simple path: {paths}")
    stems = [key for key in distinct if key[0] % 32]
    if len(stems) != 2:
        fail(f"expected one Cin-3 stem a model, found {stems}")
    print(f"[int8] both kernels equal their twins bit for bit on "
          f"{len(cases)} shapes x (bf16, f32 activations) x (bf16, f32 "
          f"output): {len(distinct)} distinct conv shapes of ResNet-50 and "
          f"HRNet-W32 at batch {B_TRAIN}, {SIZE}x{SIZE} (the stems {stems} "
          f"on the stem path), and {len(INT8_RAGGED)} "
          f"ragged ones; conv paths (cases x dtypes) {paths}; max |kernel -"
          f" twin| weights {err_w}, conv {err_c}")
    return err_w, err_c


def quant_module_phase() -> None:
    """Phase 2c: a ``QuantConv2d`` on the card equals the same module on the
    CPU, bit for bit, at ResNet-50's and HRNet-W32's heaviest shapes under
    both compute dtypes: the weight scale divides on both devices (on a CUDA
    tensor a Python-scalar divisor would be a reciprocal multiply, an ulp
    off in about one channel in twenty)."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models.layers import QuantConv2d

    for shape in ((256, 16, 16, 256, 3, 1), (32, 64, 64, 32, 3, 1)):
        cin, h, w, cout, k, stride = shape
        for dtype in (torch.bfloat16, torch.float32):
            x, wt = int8_inputs(2, shape, 7, dtype)
            policy = DTypePolicy(compute_dtype=dtype, quant_fwd=True)
            cpu = QuantConv2d(cin, cout, k, stride, policy)
            with torch.no_grad():
                cpu.weight.copy_(wt.cpu())
                want = cpu(x.cpu().contiguous())
                card = QuantConv2d(cin, cout, k, stride, policy).to(
                    "cuda", memory_format=torch.channels_last)
                card.weight.copy_(wt)
                got = card(x).cpu()
            bad = int((got != want).sum())
            print(f"[int8 module] QuantConv2d {shape} {dtype}: card vs CPU "
                  f"{bad} differing values of {got.numel()}")
            if got.shape != want.shape or bad:
                fail(f"QuantConv2d on the card differs from the CPU at "
                     f"{shape} {dtype}")


def model_quant_weights(name: str, layout) -> list:
    """The f32 master weights of model ``name``'s ``QuantConv2d`` modules
    under int8_fwd, in ``modules()`` order (the order of its forward's
    grouped quantize call), drawn by ``init_weights`` from a seed, with an
    all-zero output channel in every seventh; on the card in ``layout``
    (``channels_last``, as the models hold them there, or contiguous)."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import init_weights

    model = get_model(name, policy=DTypePolicy.int8_fwd())
    init_weights(model, torch.Generator().manual_seed(11))
    ws = []
    for i, m in enumerate(model.quant_convs):
        w = m.weight.detach().clone()
        if i % 7 == 0:
            w[min(1, w.shape[0] - 1)] = 0.0
        ws.append(w.to("cuda", memory_format=layout))
    return ws


def ragged_weight_groups() -> dict:
    """{label: weights} on the card that take every route of the grouped
    weight kernel: the stems (K = 27 and 147: the block's own loads), Cout
    40 and 33, rows of 45 values (180 bytes) and of 20 (80 bytes, K not a
    multiple of 16), an all-zero channel in each; a source 4 bytes off
    16-byte alignment (own loads), every other output channel of a weight
    (a bulk copy a row), every other input channel (strides no span
    describes: read in place) and rows of 288 KB (beyond a stage buffer:
    read in place); and a group of one."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)

    def draw(shape):
        w = (rng.normal(size=shape) * 0.05).astype(np.float32)
        w[min(1, shape[0] - 1)] = 0.0
        return torch.from_numpy(w).cuda()

    base = [draw((64, 3, 3, 3)), draw((64, 3, 7, 7)), draw((40, 64, 3, 3)),
            draw((33, 48, 1, 1)), draw((24, 5, 3, 3)), draw((16, 20, 1, 1))]
    cl = [w.contiguous(memory_format=torch.channels_last) for w in base]
    flat = torch.empty(32 * 32 * 9 + 1, device="cuda")
    off = flat[1:].view(32, 32, 3, 3)
    off.copy_(draw((32, 32, 3, 3)))
    return {
        "ragged, contiguous": base,
        "ragged, channels_last": cl,
        "strided": [off, draw((64, 32, 3, 3))[::2],
                    draw((32, 64, 3, 3))[:, ::2], draw((4, 8192, 3, 3)),
                    base[0]],
        "one": [draw((256, 256, 3, 3))],
    }


def grouped_check_phase() -> float:
    """Phase 2b, the grouped weight kernel: ``quantize_weights_cuda``
    against ``quantize_weights_plain`` on the card, bit for bit (0
    differing values of w_q, s_w and scale), over all 292 HRNet-W32 and 53
    ResNet-50 weights in one group each, channels_last and contiguous, and
    the ragged groups; every w_q ``[Cout, kh, kw, Cin]`` contiguous at a
    128-byte offset of its pool. Returns the largest |kernel - twin|."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        quantize_weights_cuda,
        quantize_weights_plain,
    )

    groups = {}
    for name in ("hrnet_w32", "resnet50"):
        for tag, layout in (("channels_last", torch.channels_last),
                            ("contiguous", torch.contiguous_format)):
            groups[f"{name}, {tag}"] = model_quant_weights(name, layout)
    groups.update(ragged_weight_groups())
    err = 0.0
    for label, ws in groups.items():
        got = quantize_weights_cuda(ws, ACT_CLIP)
        want = quantize_weights_plain(ws, ACT_CLIP)
        torch.cuda.synchronize()
        bad = 0
        base = got[0][0].data_ptr()
        for w, mine, plain in zip(ws, got, want):
            cout, cin, kh, kw = w.shape
            w_q = mine[0]
            if (w_q.shape != (cout, kh, kw, cin) or not w_q.is_contiguous()
                    or (w_q.data_ptr() - base) % 128):
                fail(f"grouped weight kernel ({label}): w_q of "
                     f"{tuple(w.shape)} is {tuple(w_q.shape)} at "
                     f"{w_q.data_ptr() - base}")
            for a, b in zip(mine, plain):
                if a.shape != b.shape:
                    fail(f"grouped weight kernel ({label}): shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
                bad += int((a != b).sum())
                err = max(err, float((a.float() - b.float()).abs().max()))
        n = sum(w.numel() for w in ws)
        print(f"[quantize_weights] {label}: {len(ws)} weights, {n} values: "
              f"{bad} differing values against the twin")
        if bad:
            fail(f"the grouped weight kernel differs from its twin "
                 f"({label}): {bad} values")
    return err


def int8_train_phase(batch, counters, n_quant: int) -> dict:
    """Phase 4b: HRNet-W32 256x256 bs32 under DTypePolicy.int8_fwd(), 3
    fused train steps. Every loss finite; K1 3 launches, the int8 conv 3 x
    the model's quantized convs, the grouped weight quantize 3 (one a
    forward). Returns the launches."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
    )

    state = create_train_state(
        get_model("hrnet_w32", policy=DTypePolicy.int8_fwd()),
        torch.Generator().manual_seed(0), lr=1e-3)
    step = make_fused_train_step(scan_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    zero(counters)
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
    counts = read(counters)
    print(f"[int8 train] HRNet-W32 {SIZE}x{SIZE} bs{B_TRAIN} int8_fwd: "
          f"losses {losses}; step ms {[round(t * 1e3, 2) for t in step_s]};"
          f" launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite int8 train loss: {losses}")
    want = {"fused_aug_targets": 3, "heatmap_targets": 0,
            "int8_conv": 3 * n_quant, "quantize_weight": 3}
    if counts != want:
        fail(f"int8 train launches {counts}, expected {want}")
    return counts


def int8_serving_phase(state, images, counters, n_quant: int) -> dict:
    """Phase 5b: phase 4's trained W32 served under bf16 and under
    int8_fwd (the same weights through load_state_dict); prints the share
    of joints whose two predictions lie within 1 heatmap px of each other
    on both axes. The int8 predict launches the conv kernel once a
    quantized conv and the grouped weight quantize once."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import create_train_state, make_predict_step

    model = get_model("hrnet_w32", policy=DTypePolicy.int8_fwd())
    model.load_state_dict(state.model.state_dict())
    int8_state = create_train_state(model)
    predict = make_predict_step()
    zero(counters)
    bf16_joints, _ = predict(state, images)
    int8_joints, maxvals = predict(int8_state, images)
    torch.cuda.synchronize()
    counts = read(counters)
    stride = SIZE / HM
    near = ((bf16_joints - int8_joints).abs() <= stride).all(-1)
    share = float(near.float().mean())
    print(f"[int8 serve] W32 after phase 4: {100 * share:.2f} % of "
          f"{near.numel()} joints within 1 heatmap px of the bf16 "
          f"prediction; launches {counts}")
    if (not torch.isfinite(int8_joints).all()
            or not torch.isfinite(maxvals).all()):
        fail("non-finite int8 predictions")
    if counts != {"fused_aug_targets": 0, "heatmap_targets": 0,
                  "int8_conv": n_quant, "quantize_weight": 1}:
        fail(f"int8 serving launches {counts}, expected {n_quant} int8 "
             "convs and 1 weight quantize")
    return counts


def _pck_rows(path: str) -> list:
    with open(path) as f:
        return [line.rstrip(";").split(";") for line in f.read().splitlines()]


def eval_cli_phase(counters, tmp: str, n_quant: int) -> tuple:
    """Phase 6d: ``lighthand_tpu_torch.cli.eval.main`` on phase 6b's run
    tree (SimpleBaseline ResNet-50, bf16) over an Armo tree of the fixture
    JPEGs (64 records, 16 per category, some joints hidden, plus 2 short
    records that are dropped), three times: with the checkpoint's precision,
    with ``--precision int8_fwd`` and with ``--test``. Checks exit code 0,
    evaluation.json's categories and counts, the three pck_eval files (5
    rows of finite AUC and EPE and 100 PCK values), the --test AUC lines,
    and under int8_fwd 53 int8 conv launches and 1 weight quantize a batch,
    none otherwise.
    Returns the launches summed over the three runs and img/s per run."""
    import numpy as np

    armo = os.path.join(tmp, "armo")
    n_rec = 64
    write_armo_tree(armo, n_rec)
    argv = ["--root", "simplebaseline/ours", "--name", "real", "--eval",
            "--dataset-root", armo, "--batch_size", str(B_TRAIN)]
    batches = math.ceil(n_rec / B_TRAIN)
    run_dir = os.path.join(tmp, "output", "simplebaseline", "ours", "real")
    total = {name: 0 for name in counters}
    ips = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for tag, extra in (("bf16", []), ("int8_fwd", ["--precision",
                                                       "int8_fwd"]),
                           ("test", ["--test"])):
            for f in os.listdir(tmp):
                if f.startswith("pck_eval_"):
                    os.remove(f)
            rc, text, wall, counts = run_cli(argv + extra, counters,
                                             f"eval {tag}", entry="eval")
            ips[tag] = n_rec / wall
            print(f"[eval {tag}] {wall:.2f} s in main = {ips[tag]:.1f} "
                  f"img/s ({n_rec} images, bs{B_TRAIN}); launches {counts}")
            if rc != 0:
                fail(f"eval CLI ({tag}) exited {rc}")
            int8 = tag == "int8_fwd"
            want = {"fused_aug_targets": 0, "heatmap_targets": 0,
                    "int8_conv": n_quant * batches if int8 else 0,
                    "quantize_weight": batches if int8 else 0}
            if counts != want:
                fail(f"eval CLI ({tag}): launches {counts}, expected {want}")
            for name in total:
                total[name] += counts[name]
            if tag == "test":
                lines = [ln for ln in text.splitlines() if "auc=" in ln]
                if len(lines) != 3 or not all(
                        math.isfinite(float(v)) for ln in lines
                        for v in re.findall(r"=(-?[0-9.]+)", ln)):
                    fail(f"eval CLI --test: bad AUC lines {lines}")
                with open(os.path.join(tmp, "final_model", "simplebaseline",
                                       "ours", "real", "test.json")) as f:
                    flat = json.load(f)[0]
                if np.asarray(flat["gt"]).shape != (1, n_rec, 21, 2):
                    fail("eval CLI --test: bad test.json")
                continue
            with open(os.path.join(run_dir, "evaluation.json")) as f:
                store = json.load(f)[0]
            counts_by_cat = {c: len(v["gt"]) for c, v in store.items()}
            if counts_by_cat != {c: n_rec // 4 for c in POSE_CATEGORIES}:
                fail(f"eval CLI ({tag}): categories {counts_by_cat}")
            files = sorted(f for f in os.listdir(tmp)
                           if f.startswith("pck_eval_"))
            if len(files) != 3:
                fail(f"eval CLI ({tag}): pck files {files}")
            for name in files:
                rows = _pck_rows(os.path.join(tmp, name))
                if ([r[0] for r in rows] != list(POSE_CATEGORIES)
                        + ["mean_auc"]
                        or any(len(r) != 104 for r in rows)
                        or not all(math.isfinite(float(v)) for r in rows
                                   for v in r[2:])):
                    fail(f"eval CLI ({tag}): bad rows in {name}")
            mean = _pck_rows(os.path.join(tmp, files[0]))[-1]
            print(f"[eval {tag}] {files[0]}: mean_auc AUC {mean[2]} EPE "
                  f"{mean[3]} mm")
    finally:
        os.chdir(cwd)
    return total, ips


def k1_agrees(got_img, want_img, got_hm, want_hm) -> tuple:
    """Phase 3's tolerances: (ok, description). The bf16 image equal on
    >= 99.9 % of elements and within max(1 bf16 ulp, F32_ATOL) everywhere,
    the targets within F32_ATOL."""
    g, w = got_img.float(), want_img.float()
    diff = (g - w).abs()
    ulp = bf16_ulp(w)
    fine = ulp < F32_ATOL
    ulps = float((diff / ulp * ~fine).max())
    near0 = float((diff * fine).max())
    equal = float((diff == 0).float().mean())
    hm_err = float((got_hm - want_hm).abs().max())
    ok = (got_img.shape == want_img.shape and ulps <= 1.0
          and near0 <= F32_ATOL and equal >= 0.999 and hm_err <= 1e-5)
    return ok, (f"max|diff| {float(diff.max()):.3g}, {ulps:.3g} ulp where a "
                f"ulp >= {F32_ATOL:g}, {near0:.3g} below; equal "
                f"{100 * equal:.4f} %; targets {hm_err:.3g}")


# the CPU tests' tolerances for the chain (tests/test_torch_step.py):
# images in ImageNet-normalised units, joints in pixels
CHAIN_IMAGE_ATOL, CHAIN_JOINT_ATOL = 3e-4, 1e-4


def aug_route_phase(counters, card: str, k1_step_ms: float) -> tuple:
    """Phase 4c: ``make_fused_train_step(flip=True, rot_deg=15.0)`` on
    HRNet-W32, 256x256, bs32, bf16 for 3 steps (finite losses, K1 0 and K2
    3 launches); the chain on the card against the same chain on the CPU
    with the same draws (f32 images within CHAIN_IMAGE_ATOL, joints within
    CHAIN_JOINT_ATOL, K2's targets from them within F32_ATOL of the plain
    targets); the chain with neither flip nor rotation, on K1's draws,
    against K1 under phase 3's tolerances; the chain's and K1's times at
    B=128. Returns the path's launches and the figures."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops.heatmap import generate_target_batch
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        fused_aug_targets_cuda,
    )
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
        make_targets,
    )
    from lighthand_tpu_torch.train.step import (
        chain_augment,
        draw_affine_params,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    batch = {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=(B_TRAIN, SIZE, SIZE, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            16, SIZE - 16, size=(B_TRAIN, JOINTS, 2)).astype(np.float32)),
        "aug_enabled": torch.from_numpy(
            (np.arange(B_TRAIN) % 2).astype(np.float32)),
    }
    batch = {k: v.to(dev) for k, v in batch.items()}
    state = create_train_state(get_model("hrnet_w32"),
                               torch.Generator().manual_seed(0), lr=1e-3)
    step = make_fused_train_step(flip=True, rot_deg=15.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    zero(counters)
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
    counts = read(counters)
    ms_step = statistics.median(step_s[1:]) * 1e3
    print(f"[aug] HRNet-W32 256x256 bs{B_TRAIN} bf16, flip + rotation 15: "
          f"losses {losses}; step ms {[round(s * 1e3, 2) for s in step_s]};"
          f" steady {ms_step:.2f} ms/step against phase 4's "
          f"{k1_step_ms:.2f} (K1); launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses on the flip/rotation route: {losses}")
    want = {"fused_aug_targets": 0, "heatmap_targets": 3, "int8_conv": 0,
            "quantize_weight": 0}
    if counts != want:
        fail(f"flip/rotation steps launched {counts}, expected {want}")

    # the chain on the card against the chain on the CPU, same draws
    images, joints, params = k1_inputs(B_TRAIN, 14)
    mask, deg = draw_affine_params(torch.Generator(device=dev).manual_seed(2),
                                   B_TRAIN, True, 15.0)
    inputs = (images, joints, params, mask, deg)
    card_img, card_j = chain_augment(*inputs, out_dtype=torch.float32)
    cpu_img, cpu_j = chain_augment(*(x.cpu() for x in inputs),
                                   out_dtype=torch.float32)
    card_hm = make_targets(cpu_j.to(dev))  # K2
    torch.cuda.synchronize()
    img_err = float((card_img.cpu() - cpu_img).abs().max())
    joint_err = float((card_j.cpu() - cpu_j).abs().max())
    hm_err = float((card_hm.cpu() - generate_target_batch(cpu_j)).abs()
                   .max())
    print(f"[aug] chain card vs CPU, B={B_TRAIN}: image max|diff| "
          f"{img_err:.3g} (atol {CHAIN_IMAGE_ATOL:g}), joints {joint_err:.3g}"
          f" px (atol {CHAIN_JOINT_ATOL:g}), K2 targets {hm_err:.3g} "
          f"(atol {F32_ATOL:g})")
    if not (img_err <= CHAIN_IMAGE_ATOL and joint_err <= CHAIN_JOINT_ATOL
            and hm_err <= F32_ATOL):
        fail("the chain on the card disagrees with the chain on the CPU")

    # neither flip nor rotation: the chain is K1's function on K1's draws
    k1_img, k1_hm = fused_aug_targets_cuda(images, joints, params)
    ch_img, ch_j = chain_augment(images, joints, params)
    ok, desc = k1_agrees(k1_img, ch_img, k1_hm, make_targets(ch_j))
    torch.cuda.synchronize()
    print(f"[aug] K1 vs the chain without flip or rotation, same draws: "
          f"{desc}")
    if not ok:
        fail("the chain without flip or rotation disagrees with K1")

    # what --flip --rot-aug costs a step: the chain beside K1 at B=128
    images, joints, params = k1_inputs(B_KERNEL, 1)
    mask, deg = draw_affine_params(torch.Generator(device=dev).manual_seed(3),
                                   B_KERNEL, True, 15.0)

    def chain():
        img, moved = chain_augment(images, joints, params, mask, deg)
        return img, make_targets(moved)

    def k1():
        return fused_aug_targets_cuda(images, joints, params)

    figures = {"step_ms": ms_step, "k1_step_ms": k1_step_ms}
    for name, fn, graph in (("chain", chain, None), ("K1", k1, capture(k1))):
        figures[f"{name}_eager_ms"] = eager_ms(fn)
        figures[f"{name}_device_ms"], how = device_ms(fn, graph)
        print(f"[aug] {name} B={B_KERNEL} 256x256 bf16 + targets: eager "
              f"{figures[f'{name}_eager_ms']:.4f} ms, device "
              f"{figures[f'{name}_device_ms']:.4f} ms ({how}) on {card}")
    return counts, figures, hm_err


def _strip_dist_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if not k.startswith("LIGHTHAND_")}


def aug_cli_phase(counters, tmp: str) -> dict:
    """Phase 6e: the training CLI with ``--flip --rot-aug 15``
    (SimpleBaseline ResNet-50, synthetic data, 64 train and 32 val
    samples, bs32, 1 epoch): the done line, finite Loss/train and
    Loss/valid, K1 0 and K2 3 launches (2 steps, 1 eval batch) and the
    route's log line once. Returns the launches."""
    import logging

    argv = ["--root", "simplebaseline/ours", "--name", "affine",
            "--synthetic", "--batch_size", str(B_TRAIN), "--num_our", "64",
            "--epoch", "1", "--count", "5", "--flip", "--rot-aug", "15",
            "--reset", "--yes"]
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    route_log = logging.getLogger("lighthand_tpu_torch")
    keep = Keep()
    route_log.addHandler(keep)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, text, wall, counts = run_cli(argv, counters, "cli affine")
        rows = _scalars(os.path.join("output", "simplebaseline", "ours",
                                     "affine"))
    finally:
        os.chdir(cwd)
        route_log.removeHandler(keep)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    routed = [m for m in records if "K1" in m]
    print(f"[cli affine] {wall:.1f} s in main; Loss/train {train}, "
          f"Loss/valid {valid}; launches {counts}; route log lines {routed}")
    check_run("flip/rotation CLI", rc, text, train, valid, [0])
    want = {"fused_aug_targets": 0, "heatmap_targets": 64 // B_TRAIN + 1,
            "int8_conv": 0, "quantize_weight": 0}
    if counts != want:
        fail(f"flip/rotation CLI: launches {counts}, expected {want}")
    if len(routed) != 1:
        fail(f"flip/rotation CLI logged its route {len(routed)} times")
    return counts


DIST_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from lighthand_tpu_torch.cli import train
from lighthand_tpu_torch.ops.kernels.fused_aug import fused_aug_targets_cuda
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda
rc = train.main(sys.argv[2:])
print("LAUNCHES " + json.dumps({
    "fused_aug_targets": fused_aug_targets_cuda.launches,
    "heatmap_targets": generate_target_batch_cuda.launches}))
sys.exit(rc)
"""


DIST_STEP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.distributed as dist
from lighthand_tpu_torch.core.dist import (maybe_initialize_distributed,
                                          process_device)
from lighthand_tpu_torch.core.mesh import MeshSpec, create_mesh, is_sharded
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.train import create_train_state, make_fused_train_step
assert maybe_initialize_distributed()
dev = process_device()
mesh = create_mesh(MeshSpec(1, 1), dev)
b, size = int(sys.argv[2]), int(sys.argv[3])
rng = np.random.default_rng(0)
batch = {k: torch.from_numpy(v).to(dev) for k, v in {
    "image_u8": rng.integers(0, 256, size=(b, size, size, 3), dtype=np.uint8),
    "joints": rng.uniform(16, size - 16, size=(b, 21, 2)).astype(np.float32),
    "aug_enabled": (np.arange(b) % 2).astype(np.float32)}.items()}
import time
ms, adam, losses = {"plain": [], "mesh": []}, {"plain": [], "mesh": []}, []
wrap, states, steps, gens = {}, {}, {}, {}
for tag in ("plain", "mesh"):
    m = mesh if tag == "mesh" else None
    state = create_train_state(get_model("hrnet_w32"),
                               torch.Generator().manual_seed(0), lr=1e-3,
                               device=dev, mesh=m)
    wrap[tag] = {"sharded": is_sharded(state.model), "channels_last": all(
        p.is_contiguous(memory_format=torch.channels_last)
        for p in state.model.parameters() if p.ndim == 4),
        "grad_group": state.grad_group is not None}
    states[tag], steps[tag] = state, make_fused_train_step(device=dev, mesh=m)
    gens[tag] = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        steps[tag](state, gens[tag], batch)
# single steps (and blocks of 5 Adam steps) of the two states interleaved,
# which goes first alternating: the host-bound step's runs drift by more
# than the routes could differ
for i in range(24):
    for tag in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = steps[tag](states[tag], gens[tag], batch)
        torch.cuda.synchronize()
        ms[tag].append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
for i in range(12):
    for tag in (("plain", "mesh") if i % 2 == 0 else ("mesh", "plain")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            states[tag].optimizer.step()
        torch.cuda.synchronize()
        adam[tag].append((time.perf_counter() - t0) * 1e3 / 5)
del states, steps, state
torch.cuda.empty_cache()
# where the sharded step's time goes: the profiler over 3 steady steps of
# each; ranges (FSDP's hooks, the optimizer) are kept apart from ops
from torch.profiler import ProfilerActivity, profile
prof = {}
for tag in ("plain", "mesh"):
    m = mesh if tag == "mesh" else None
    state = create_train_state(get_model("hrnet_w32"),
                               torch.Generator().manual_seed(0), lr=1e-3,
                               device=dev, mesh=m)
    step = make_fused_train_step(device=dev, mesh=m)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        step(state, gen, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(3):
            step(state, gen, batch)
        torch.cuda.synchronize()
    events = p.key_averages()
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    ranges = {}
    for e in events:
        if e.key.startswith(("FSDP::", "Optimizer.")):
            ranges[e.key] = max(ranges.get(e.key, 0.0),
                                e.cpu_time_total / 3e3)
    ops = [e for e in events if not e.key.startswith(
        ("FSDP::", "Optimizer.", "ProfilerStep"))]
    top = lambda f: [(e.key[:64], round(f(e) / 3e3, 3), e.count // 3)
                     for e in sorted(ops, key=lambda e: -f(e))[:8]]
    prof[tag] = {"device_ms": sum(map(dev_us, ops)) / 3e3,
                 "ranges_host_ms": ranges,
                 "top_device_ms": top(dev_us),
                 "top_host_ms": top(lambda e: e.self_cpu_time_total)}
    del state, step
    torch.cuda.empty_cache()
print("STEP_MS " + json.dumps({"ms": ms, "adam": adam, "losses": losses,
                               "backend": dist.get_backend(),
                               "profile": prof, "wrap": wrap}))
dist.destroy_process_group()
"""


def dist_step_times(env: dict, tmp: str) -> dict:
    """The steady train step of phase 4 (HRNet-W32, bs32, 256x256, bf16, K1
    route), plain and on a 1 x 1 mesh (replicated: plain, channels_last
    parameters, checked), in one NCCL process at world size 1: the two
    states side by side after 3 steps each, 24 single steps of each
    interleaved (host clock between synchronisations, the first of each
    pair alternating), their medians; then ms an Adam step alone, 12
    blocks of 5 of each interleaved (the ``*_adam`` keys); then the
    profiler's view of 3 steps of each (``profile``: device ms a step, the
    host ms of FSDP's and the optimizer's ranges, the top operations by
    device and by host time)."""
    out = subprocess.run(
        [sys.executable, "-c", DIST_STEP_CHILD, REPO, str(B_TRAIN),
         str(SIZE)], cwd=tmp, env=env, capture_output=True, text=True,
        timeout=300)
    if out.returncode != 0 or "STEP_MS " not in out.stdout:
        print(out.stdout[-2000:], out.stderr[-4000:])
        fail(f"the mesh step-time subprocess exited {out.returncode}")
    got = json.loads(out.stdout.split("STEP_MS ")[-1])
    if got["backend"] != "nccl" or not all(map(math.isfinite,
                                               got["losses"])):
        fail(f"the mesh step-time run: {got}")
    replicated = {"sharded": False, "channels_last": True,
                  "grad_group": False}
    print(f"[dist] how each step's model is held: {got['wrap']}")
    if got["wrap"] != {"plain": replicated, "mesh": replicated}:
        fail(f"the 1 x 1 mesh's model is not plain and channels_last as "
             f"the plain one: {got['wrap']}")
    for tag, prof in got["profile"].items():
        print(f"[dist profile] {tag}: device {prof['device_ms']:.2f} ms a "
              f"step; ranges (host ms a step) {prof['ranges_host_ms']}")
        for kind in ("top_device_ms", "top_host_ms"):
            print(f"[dist profile] {tag} {kind} (op, ms a step, calls a "
                  f"step): {prof[kind]}")
    return {**{tag: statistics.median(v) for tag, v in got["ms"].items()},
            **{f"{tag}_adam": statistics.median(v)
               for tag, v in got["adam"].items()},
            "adam_runs": got["adam"], "step_runs": got["ms"]}


def dist_phase(counters, tmp: str) -> dict:
    """Phase 6f: ``cli.train`` in a subprocess under the environment
    contract (``LIGHTHAND_COORDINATOR`` on a free local port, 1 process,
    rank 0, ``--mesh-data 1 --mesh-model 1``) against a plain subprocess
    run of the same seed (SimpleBaseline ResNet-50, f32 as the JAX bound's
    run, synthetic data, 64 train and 32 val samples, bs32, 1 epoch; each
    under the f32 policy's own full-f32 setting, which the child does not
    touch). Checks the NCCL backend and the replicated (not sharded)
    model in the run's log line, Loss/train and Loss/valid within 5e-3
    relative of the plain run, and that ``cli.eval`` reads the checkpoint
    rank 0 wrote; times phase 4's step plain and on a 1 x 1 mesh
    (``dist_step_times``), the mesh step within 10 % of the plain one. Returns
    the distributed run's launches, the loss gaps and the step times."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = ["--root", "simplebaseline/ours", "--synthetic", "--batch_size",
            str(B_TRAIN), "--num_our", "64", "--epoch", "1", "--count", "5",
            "--precision", "f32", "--reset", "--yes"]
    runs = {}
    for tag, extra, env in (
            ("plain", [], _strip_dist_env()),
            ("dist", ["--mesh-data", "1", "--mesh-model", "1"],
             dict(_strip_dist_env(), LIGHTHAND_COORDINATOR=f"localhost:{port}",
                  LIGHTHAND_NUM_PROCESSES="1", LIGHTHAND_PROCESS_ID="0"))):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", DIST_CHILD, REPO, *base, "--name", tag,
             *extra], cwd=tmp, env=env, capture_output=True, text=True,
            timeout=300)
        wall = time.perf_counter() - t0
        print("\n".join(f"[{tag}] {ln}" for ln in out.stdout.splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:])
            fail(f"the {tag} training subprocess exited {out.returncode}")
        launches = json.loads(out.stdout.split("LAUNCHES ")[-1])
        rows = _scalars(os.path.join(tmp, "output", "simplebaseline", "ours",
                                     tag))
        runs[tag] = (out.stdout, launches, _by_epoch(rows, "Loss/train"),
                     _by_epoch(rows, "Loss/valid"))
        print(f"[{tag}] {wall:.1f} s (process start included); launches "
              f"{launches}")
        check_run(f"{tag} CLI", 0, out.stdout, runs[tag][2], runs[tag][3],
                  [0])
    text, launches = runs["dist"][0], runs["dist"][1]
    if "Mesh: {'data': 1, 'model': 1} over nccl, model sharded False" \
            not in text:
        fail("the distributed run did not report an NCCL group and a "
             "replicated model")
    if "Mesh: one process" not in runs["plain"][0]:
        fail("the plain run reported a mesh")
    gaps = {}
    for i, tag in ((2, "Loss/train"), (3, "Loss/valid")):
        got, want = runs["dist"][i][0], runs["plain"][i][0]
        gaps[tag] = abs(got - want) / abs(want)
        print(f"[dist] {tag}: world-size-1 NCCL {got!r} vs plain {want!r}, "
              f"relative gap {gaps[tag]:.3g} (bound 5e-3)")
    if max(gaps.values()) > 5e-3:
        fail(f"the distributed run's losses differ from the plain run's: "
             f"{gaps}")
    want = {"fused_aug_targets": 64 // B_TRAIN, "heatmap_targets": 1}
    if launches != want:
        fail(f"distributed CLI: launches {launches}, expected {want}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    step_ms = dist_step_times(
        dict(_strip_dist_env(), LIGHTHAND_COORDINATOR=f"localhost:{port}",
             LIGHTHAND_NUM_PROCESSES="1", LIGHTHAND_PROCESS_ID="0"), tmp)
    ratio = step_ms["mesh"] / step_ms["plain"]
    runs = {k: [round(x, 2) for x in v]
            for k, v in step_ms["step_runs"].items()}
    adam_runs = {k: [round(x, 2) for x in v]
                 for k, v in step_ms["adam_runs"].items()}
    print(f"[dist] HRNet-W32 bs{B_TRAIN} bf16 steady step at world size 1 "
          f"over NCCL, median of 24 interleaved single steps: plain "
          f"{step_ms['plain']:.2f} ms, 1 x 1 mesh (replicated, "
          f"channels_last) {step_ms['mesh']:.2f} ms, mesh / plain "
          f"{ratio:.3f} (bound 1.10; steps {runs}); Adam alone, median of 12 "
          f"blocks of 5: {step_ms['plain_adam']:.2f} and "
          f"{step_ms['mesh_adam']:.2f} ms (mesh / plain "
          f"{step_ms['mesh_adam'] / step_ms['plain_adam']:.3f}; {adam_runs})")
    if ratio > 1.10:
        fail(f"the 1 x 1 mesh step is {ratio:.3f}x the plain one (bound "
             "1.10)")

    armo = os.path.join(tmp, "armo_dist")
    write_armo_tree(armo, 32)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, _, wall, counts = run_cli(
            ["--root", "simplebaseline/ours", "--name", "dist", "--eval",
             "--dataset-root", armo, "--batch_size", str(B_TRAIN)],
            counters, "eval dist", entry="eval")
        with open(os.path.join("output", "simplebaseline", "ours", "dist",
                               "evaluation.json")) as f:
            store = json.load(f)[0]
    finally:
        os.chdir(cwd)
    by_cat = {c: len(v["gt"]) for c, v in store.items()}
    print(f"[eval dist] rank 0's checkpoint through cli.eval: rc {rc}, "
          f"{wall:.2f} s, categories {by_cat}")
    if rc != 0 or by_cat != {c: 8 for c in POSE_CATEGORIES}:
        fail("cli.eval did not read the distributed run's checkpoint")
    print("[dist] meshes above one process (data or model axis > 1) are "
          "rehearsed only on the CPU, in gloo processes "
          "(tests/test_torch_dist.py): this machine has one GPU")
    return {**launches, "int8_conv": 0, "quantize_weight": 0}, gaps, step_ms


def synth_tree_phase(tmp: str) -> tuple:
    """Phase 9a: ``python -m lighthand_tpu_torch.cli.make_synth_data`` with
    ``SYNTH_ARGS`` into ``tmp``: every file's SHA-256 equal to the stored
    digests of the JAX CLI's tree (JSON up to the output root). Returns the
    tree's root and the host img/s of the writing."""
    out = os.path.join(tmp, "synth")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lighthand_tpu_torch.cli.make_synth_data",
         "--out", out, *SYNTH_ARGS], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:])
        fail(f"make_synth_data exited {proc.returncode}")
    with open(DIGESTS) as f:
        want = json.load(f)["make_synth_data"]["files"]
    got = tree_digests(out)
    wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    n_img = sum(int(v) for v in SYNTH_ARGS[1::2])
    print(f"[synth tree] {len(got)} files, {len(got) - len(wrong)} equal to "
          f"the JAX CLI's digests; {n_img} images rendered and written in "
          f"{wall:.2f} s = {n_img / wall:.1f} img/s on the host (one "
          "process, its start included)")
    if wrong:
        fail(f"make_synth_data's tree differs from the JAX CLI's in "
             f"{len(wrong)} files, e.g. {wrong[:5]}")
    return out, {"img_s": n_img / wall, "seconds": wall}


def encode_phase(codec_ms: dict) -> dict:
    """Phase 9b: host ms of one 224x224 RGB JPEG encode at quality 95 (a
    fixture image) and of one decode of its bytes, one thread, beside
    phase 1b's figures."""
    from lighthand_tpu_torch.data import imageio

    img = imageio.imread_rgb(_square_jpegs()[0]["path"])
    data = imageio.encode_jpeg_rgb(img, 95)
    back = imageio.imdecode_rgb(data)
    if back.shape != img.shape:
        fail(f"the encoder's JPEG decodes to {back.shape}")
    times = {}
    for name, fn in (("encode_224_q95", lambda: imageio.encode_jpeg_rgb(
            img, 95)), ("decode_224", lambda: imageio.imdecode_rgb(data))):
        fn()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        times[name] = (time.perf_counter() - t0) / 200 * 1e3
    print(f"[jpeg] host ms per call, one thread: {times} (phase 1b: "
          f"{codec_ms}); {len(data)} bytes")
    return times


def overlay_cli_phase(counters, tmp: str, synth: str) -> tuple:
    """Phase 9c: ``cli.train`` (SimpleBaseline ResNet-50, bs32, bf16, 1
    epoch) on 9a's LightHand tree with overlays on (the default): the done
    line, finite losses, K1 2 and K2 1 launches, the train overlays at
    iterations {0, 1} and the val overlay at 0, each decoding to 256x512x3.
    Returns the launches and the epoch's seconds and host ms per
    overlay."""
    from lighthand_tpu_torch.data import imageio

    argv = ["--root", "simplebaseline/ours", "--name", "overlay",
            "--dataset-root", synth, "--batch_size", str(B_TRAIN),
            "--num_our", "64", "--epoch", "1", "--count", "5", "--reset",
            "--yes"]
    run_dir = os.path.join(tmp, "output", "simplebaseline", "ours",
                           "overlay")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, text, wall, counts = run_cli(argv, counters, "cli overlay")
    finally:
        os.chdir(cwd)
    rows = _scalars(run_dir)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    check_run("overlay CLI", rc, text, train, valid, [0])
    want = {"fused_aug_targets": 64 // B_TRAIN, "heatmap_targets": 1,
            "int8_conv": 0, "quantize_weight": 0}
    if counts != want:
        fail(f"overlay CLI: launches {counts}, expected {want}")
    files = sorted(os.path.relpath(os.path.join(d, f), run_dir)
                   for d, _, fs in os.walk(run_dir) for f in fs
                   if f.endswith(".jpg"))
    expect = sorted([os.path.join("train_image", "0_epoch", f"iter_{i}.jpg")
                     for i in (0, 1)]
                    + [os.path.join("val_image", "0_epoch", "iter_0.jpg")])
    if files != expect:
        fail(f"overlay CLI wrote {files}, expected {expect}")
    for rel in files:
        shape = imageio.imread_rgb(os.path.join(run_dir, rel)).shape
        if shape != (SIZE, 2 * SIZE, 3):
            fail(f"overlay {rel} decodes to {shape}")
    with open(os.path.join(run_dir, "log.txt")) as f:
        ms = [float(v) for v in re.findall(r"overlay \w+ \d+ \d+: ([0-9.]+) ms",
                                           f.read())]
    secs = _by_epoch(rows, "perf/epoch_seconds")
    print(f"[cli overlay] {wall:.1f} s in main; epoch wall s {secs}; "
          f"overlays {files}; host ms per overlay (draw, encode, write) "
          f"{ms}; launches {counts}")
    if len(ms) != len(expect):
        fail(f"overlay CLI logged {len(ms)} overlay times")
    return counts, {"epoch_s": secs[0], "overlay_ms": ms}


def plt_eval_phase(counters, tmp: str, synth: str) -> dict:
    """Phase 9d: ``cli.eval --plt --plt_max 8`` on 9a's Armo tree (32
    records) with 9c's checkpoint: exactly 8 overlay JPEGs, and
    evaluation.json holding all 32 rows. Returns the launches."""
    run_dir = os.path.join(tmp, "output", "simplebaseline", "ours",
                           "overlay")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, _, wall, counts = run_cli(
            ["--root", "simplebaseline/ours", "--name", "overlay", "--eval",
             "--dataset-root", synth, "--batch_size", str(B_TRAIN), "--plt",
             "--plt_max", "8"], counters, "eval plt", entry="eval")
    finally:
        os.chdir(cwd)
    with open(os.path.join(run_dir, "evaluation.json")) as f:
        store = json.load(f)[0]
    n_rows = sum(len(v["gt"]) for v in store.values())
    jpgs = sorted(os.listdir(os.path.join(run_dir, "eval_image", "0_epoch")))
    print(f"[eval plt] rc {rc}, {wall:.2f} s; {len(jpgs)} overlays "
          f"{jpgs}; {n_rows} rows in evaluation.json; launches {counts}")
    if rc != 0 or n_rows != 32:
        fail(f"cli.eval --plt: rc {rc}, {n_rows} rows (expected 32)")
    if jpgs != [f"iter_{i}.jpg" for i in sorted(range(8), key=str)]:
        fail(f"cli.eval --plt --plt_max 8 wrote {jpgs}")
    return counts


def make_lighthand_phase(tmp: str) -> None:
    """Phase 9e: ``python -m lighthand_tpu_torch.cli.make_lighthand`` over
    ``write_armhand_tree``'s capture tree: every output file's SHA-256
    equal to the stored digests of the JAX CLI's tree."""
    raw, out = os.path.join(tmp, "armhand"), os.path.join(tmp, "lighthand")
    phase = write_armhand_tree(raw)
    with open(DIGESTS) as f:
        want = json.load(f)["make_lighthand"]
    proc = subprocess.run(
        [sys.executable, "-m", "lighthand_tpu_torch.cli.make_lighthand",
         "--root", raw, "--out", out, "--phase", phase, "--seed",
         str(want["seed"])], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:])
        fail(f"make_lighthand exited {proc.returncode}")
    got = tree_digests(out)
    wrong = sorted(k for k in set(got) | set(want["files"])
                   if got.get(k) != want["files"].get(k))
    print(f"[make_lighthand] {proc.stdout.strip()}; {len(got)} files, "
          f"{len(got) - len(wrong)} equal to the JAX CLI's digests")
    if wrong:
        fail(f"make_lighthand's tree differs from the JAX CLI's: {wrong}")


def drawing_phase(tmp: str) -> None:
    """Phase 9g: the landmark and skeleton overlays on this machine's host
    (``utils/landmarks.py``, ``utils/vis3d.py`` over ``utils/visualize.py``'s
    thick line, outline circle and arrow): every drawing and written JPEG of
    ``overlay_drawings`` equal to the stored digests of what the JAX package
    and cv2 5.0.0 draw (this machine's cv2 differs and is not used); the
    ``.png`` route's file decodes (the port's decoder) to the drawn pixels;
    host ms of each overlay."""
    import numpy as np

    from lighthand_tpu_torch.data import imageio
    from lighthand_tpu_torch.utils import landmarks, vis3d
    from lighthand_tpu_torch.utils import visualize as v

    t0 = time.perf_counter()
    drawings = overlay_drawings(v.draw_line, v.draw_circle,
                                v.draw_arrowed_line, landmarks, vis3d, tmp)
    wall = time.perf_counter() - t0
    with open(OVERLAY_DIGESTS) as f:
        want = json.load(f)["files"]
    got = overlay_digests(drawings)
    wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    print(f"[drawing] {len(got)} drawings and files, {len(got) - len(wrong)} "
          f"equal to the digests of the JAX package's cv2 5.0.0 drawings; "
          f"{wall * 1e3:.1f} host ms for all")
    if wrong:
        fail(f"the port's overlays differ from the JAX package's: {wrong}")
    path = os.path.join(tmp, "kp.png")
    img = np.zeros((224, 224, 3), np.uint8)
    kps = np.random.default_rng(5).uniform(0, 224, size=(21, 2))
    canvas = vis3d.vis_keypoints(img, kps, np.ones(21),
                                 vis3d.hand_skeleton_21(), filename=path)
    if not np.array_equal(imageio.imread_rgb(path), canvas):
        fail("the .png route's file does not decode to the drawn pixels")
    times = {}
    for name, fn in (
            ("draw_landmarks", lambda: landmarks.draw_landmarks(
                img.copy(), np.random.default_rng(6).uniform(0, 1, (21, 4)),
                landmarks.HAND_CONNECTIONS)),
            ("vis_keypoints", lambda: vis3d.vis_keypoints(
                img, kps, np.ones(21), vis3d.hand_skeleton_21()))):
        fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        times[name] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"[drawing] .png route decodes to its pixels; host ms per 224x224 "
          f"overlay, one thread: {times}")
    print("[drawing] plot_landmarks and vis_3d_keypoints (Matplotlib "
          "figures) are tested on the CPU only (tests/test_torch_landmarks.py"
          ", tests/test_torch_vis3d.py): this machine has no matplotlib")


def procedural_hand_mesh(n: int = 28, seed: int = 0, dup: int = 60):
    """A MANO-sized mesh: a closed ellipsoid of 2 n (n - 1) faces (1512 at
    n = 28, MANO has 1538) with seeded bumps, then ``dup`` of its faces again
    over copies of their vertices (the same positions, other colours):
    coplanar faces of equal depth, whose pixels the face first in index
    order keeps. Returns (vertices [V, 3], faces [F, 3], vertex colours
    [V, 3]), numpy f64 and int64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    th = np.linspace(0.05, np.pi - 0.05, n)
    ph = np.linspace(0, 2 * np.pi, n, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    rad = 0.08 * (1 + 0.1 * rng.normal(size=t.shape))
    v = np.stack([rad * np.sin(t) * np.cos(p), 1.6 * rad * np.cos(t),
                  rad * np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    faces = []
    for i in range(n - 1):
        for j in range(n):
            a, b = i * n + j, i * n + (j + 1) % n
            faces += [[a, a + n, b], [b, a + n, b + n]]
    faces = np.array(faces)
    picked = faces[rng.choice(len(faces), dup, replace=False)]
    used = np.unique(picked)
    remap = {int(k): len(v) + i for i, k in enumerate(used)}
    copies = np.vectorize(remap.get)(picked)
    v = np.concatenate([v, v[used]])
    colors = rng.uniform(0, 1, size=(len(v), 3))
    return v, np.concatenate([faces, copies]), colors


def raster_edge_cases(tile=(16, 16), cap: int = 256, seed: int = 5) -> dict:
    """{label: (verts_px [V, 2], verts_z [V], faces [F, 3], vertex colours
    [V, 3], background [H, W, 3], far)}, numpy f64 and int64, drawn from
    ``seed``: the rasterizer's edge cases for a kernel of ``tile`` (W, H)
    pixels a block and a list of ``cap`` faces (a geometry of
    ``ops/kernels/rasterize.py``), near 1.0:

    - "crowded": 3 cap + 7 faces that each have a corner in the first tile,
      then 40 of them again over copies of their vertices (coplanar ties,
      other colours), on an image of 3 x 2 tiles and a bit: one tile meets
      more faces than its list holds;
    - "large": a face larger than a tile and than the image, between small
      faces before and after it in index order;
    - "off-screen": faces partly off every edge, some wholly off, under a
      finite far (per-pixel far test and far cull);
    - "1x1": a 1x1 image under faces that cover its pixel and one that
      does not;
    - "17x13": an image of less than a tile under a small seeded hand mesh.

    Colours span [-0.5, 1.5] and backgrounds [-0.2, 1.2]: the clip acts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tw, th = tile
    cases = {}

    def finish(label, px, z, faces, w, h, far=float("inf")):
        colors = rng.uniform(-0.5, 1.5, size=(len(px), 3))
        bg = rng.uniform(-0.2, 1.2, size=(h, w, 3))
        cases[label] = (np.asarray(px, np.float64), np.asarray(z, np.float64),
                        np.asarray(faces, np.int64), colors, bg, far)

    w, h = 3 * tw + 5, 2 * th + 3
    nf = 3 * cap + 7
    px = rng.uniform([-5, -5], [w + 5, h + 5], size=(nf, 3, 2))
    px[:, 0] = rng.uniform([0, 0], [tw, th], size=(nf, 2))
    z = rng.choice(np.linspace(1.5, 6.0, 10), size=(nf, 3))
    faces = np.arange(3 * nf).reshape(nf, 3)
    picked = faces[rng.choice(nf, 40, replace=False)]
    faces = np.concatenate([faces, 3 * nf + np.arange(120).reshape(40, 3)])
    px = np.concatenate([px.reshape(-1, 2), px.reshape(-1, 2)[picked.ravel()]])
    z = np.concatenate([z.ravel(), z.ravel()[picked.ravel()]])
    finish("crowded", px, z, faces, w, h)

    w, h = 2 * tw + 9, th + 7
    small = rng.uniform([0, 0], [w, h], size=(30, 1, 2)) + rng.uniform(
        -4, 4, size=(30, 3, 2))
    big = np.array([[[-50.0, -40.0], [w + 60.0, -30.0], [w / 2, h + 80.0]]])
    px = np.concatenate([small[:15], big, small[15:]]).reshape(-1, 2)
    z = np.concatenate([rng.uniform(2.0, 6.0, (15, 3)), [[3.9, 4.1, 4.0]],
                        rng.uniform(2.0, 6.0, (15, 3))]).ravel()
    finish("large", px, z, np.arange(93).reshape(31, 3), w, h)

    w, h = 37, 29
    px = rng.uniform([-30, -30], [w + 30, h + 30], size=(60, 3, 2))
    px[:6, :, 0] -= w + 40  # wholly left of the image
    z = rng.uniform(1.2, 5.0, size=(60, 3))
    z[6:10] = 4.8  # beyond far: culled
    finish("off-screen", px.reshape(-1, 2), z.ravel(),
           np.arange(180).reshape(60, 3), w, h, far=4.5)

    px = np.array([[-1.0, -1.0], [3.0, -1.0], [-1.0, 3.0],
                   [-2.0, -2.0], [4.0, 0.2], [0.3, 4.0],
                   [0.7, 0.7], [2.0, 0.7], [0.7, 2.0]])
    finish("1x1", px, [3.0, 3.0, 3.0, 2.5, 3.5, 2.0, 1.5, 1.5, 1.5],
           [[0, 1, 2], [3, 4, 5], [0, 1, 2], [6, 7, 8]], 1, 1)

    v, f, _ = procedural_hand_mesh(n=10, seed=seed, dup=8)
    depth = v[:, 2] + 2.0
    px = 60.0 * v[:, :2] / depth[:, None] + np.array([17 / 2, 13 / 2])
    finish("17x13", px, depth, f, 17, 13)
    return cases


# f64 operations of the rasterizer: at each pixel of a drawn face's box,
# two barycentrics (12), w0 (2), the inside test (3), 1/z (5), the depth
# (2) and its two compares (2); at each covered pixel, three channels of
# three (w * c) / z terms summed (24) and times the depth (3)
RASTER_OPS_PER_BOX_PIXEL = 26
RASTER_OPS_PER_COVERED_PIXEL = 27
RENDER_SIZES = ((800, 600, 5000.0), (224, 224, 1500.0))  # W, H, focal


def _bits_equal(a, b) -> bool:
    """f64 tensors equal bit for bit (NaN where NaN)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def _kernel_device_ms(fn, prefixes, calls: int = 20) -> tuple:
    """(the profiler's device ms per call, kernels launched per call) of the
    kernels whose names hold one of ``prefixes`` (the wrapper's checks and
    copies left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if any(p in e.key for p in prefixes)]
    us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    return us / 1e3 / calls, sum(e.count for e in events) / calls


def render_phase(kind: str) -> tuple:
    """Phase 9h: the mesh renderer on the card. The rasterizer kernel
    (``csrc/rasterize.cu``) against its plain twin run on the card on the
    same inputs, equal bit for bit: ``procedural_hand_mesh`` (with its 60
    coplanar copies) projected at 800x600 and 224x224, its shading and its
    vertex colours, over an image and over NaN; and ``raster_edge_cases``
    at the kernel's geometry (more faces on one tile than its list holds, a
    face larger than a tile, faces off the image, 1x1 and 17x13 images).
    Then ``Renderer.render`` and ``render_vertex_color`` end to end on the
    card at both sizes, every count zeroed just before and read just after
    (one rasterizer launch a render), each image against the same render on
    the CPU. Then, at each size, the kernel's eager and device ms and its
    device kernels a call (at most 2) beside the twin's ms and the bound
    (bytes, or the f64 operations of the drawn faces' box pixels), and the
    bytes a call allocates (nothing a pixel but the image). Returns (the
    kernels-line row at 800x600, the render path's launches)."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops.kernels.rasterize import (
        FACE_BYTES,
        GROUP_BYTES,
        LARGE,
        SMALL,
        _face_setup,
        _sm_count,
        choose_geometry,
        rasterize_mesh_cuda,
        rasterize_mesh_plain,
    )
    from lighthand_tpu_torch.utils import mesh_render

    dev = torch.device("cuda")
    v, f, colors = procedural_hand_mesh()
    cam_t = np.array([0.01, -0.02, 2.0])
    rng = np.random.default_rng(8)
    inputs = {}
    for w, h, focal in RENDER_SIZES:
        px, z = mesh_render.project_points(v, np.zeros(3), cam_t,
                                           [focal, focal], [w / 2, h / 2],
                                           dev)
        shaded = mesh_render.Renderer(w, h, faces=f, device=dev)._shade(
            v, f, [0.65098039, 0.74117647, 0.85882353])
        far = abs(2.0 - float(np.mean(v, axis=0)[2])) + 20.0
        faces = torch.from_numpy(f).to(dev)
        image = torch.from_numpy(rng.uniform(0, 1, (h, w, 3))).to(dev)
        nan = torch.full((h, w, 3), float("nan"), dtype=torch.float64,
                         device=dev)
        vc = torch.from_numpy(colors).to(dev)
        for attr, bg in ((shaded, image), (vc, nan)):
            got = rasterize_mesh_cuda(px, z, faces, attr, bg, 1.0, far)
            want = rasterize_mesh_plain(px, z, faces, attr, bg, 1.0, far)
            torch.cuda.synchronize()
            if not _bits_equal(got, want):
                diff = (got - want).abs().nan_to_num(nan=float("inf"))
                fail(f"the rasterizer at {w}x{h} differs from its twin: "
                     f"{int((diff != 0).any(-1).sum())} pixels, max "
                     f"{float(diff.max()):.3g}")
        covered = int(torch.isfinite(got).all(-1).sum())
        _, _, _, box, keep = _face_setup(px, z, faces, h, w, 1.0, far)
        box_px = int(((box[:, 1] - box[:, 0]) * (box[:, 3] - box[:, 2]))
                     [keep].sum())
        print(f"[rasterize] {w}x{h}, {len(f)} faces ({int(keep.sum())} "
              f"drawn, {box_px} box pixels, {covered} covered): kernel "
              "equal to its twin bit for bit, shaded over an image and "
              "vertex colours over NaN")
        inputs[w, h] = (px, z, faces, shaded, image, far, box_px, covered)
    for geometry in (LARGE, SMALL):
        tile, sub, cap = geometry
        for label, case in raster_edge_cases(tile, cap).items():
            px, z, faces, cl, bg = (torch.from_numpy(np.ascontiguousarray(
                a)).to(dev) for a in case[:5])
            got = rasterize_mesh_cuda(px, z, faces, cl, bg, 1.0, case[5],
                                      geometry)
            want = rasterize_mesh_plain(px, z, faces, cl, bg, 1.0, case[5])
            torch.cuda.synchronize()
            if not _bits_equal(got, want):
                fail(f"the rasterizer at {geometry} differs from its twin "
                     f"on the {label} mesh: "
                     f"{int((got != want).any(-1).sum())} pixels")
        print(f"[rasterize] edge cases {sorted(raster_edge_cases(tile, cap))}"
              f" at tile {tile}, {sub} threads a pixel, a list of {cap}: "
              "kernel equal to its twin bit for bit")

    counters = {"rasterize": rasterize_mesh_cuda}
    zero(counters)
    renders = {}
    for w, h, focal in RENDER_SIZES:
        kw = dict(camera_t=cam_t, focal_length=focal)
        for route in ("render", "render_vertex_color"):
            extra = {} if route == "render" else {"vertex_color": colors}
            imgs = []
            for where in (dev, "cpu"):
                r = mesh_render.Renderer(w, h, faces=f, device=where)
                imgs.append(getattr(r, route)(v, **kw, **extra))
            card, cpu = imgs[0].cpu(), imgs[1]
            renders[w, h, route] = (float((card - cpu).abs().max()),
                                    int((card != cpu).any(-1).sum()))
    launches = read(counters)
    print(f"[render] Renderer on the card against the CPU (max |diff|, "
          f"pixels that differ): {renders}; launches {launches}")
    if launches["rasterize"] != 2 * len(RENDER_SIZES):
        fail(f"the renders launched the rasterizer {launches} times")
    if any(e > 1e-9 or n > 50 for e, n in renders.values()):
        fail(f"the card's renders differ from the CPU's: {renders}")

    row = None
    for w, h, _ in RENDER_SIZES:
        px, z, faces, shaded, image, far, box_px, covered = inputs[w, h]
        args = (px, z, faces, shaded, image, 1.0, far)
        ms = eager_ms(lambda: rasterize_mesh_cuda(*args))
        dev_ms, per_call = _kernel_device_ms(
            lambda: rasterize_mesh_cuda(*args), ("raster_",))
        if per_call > 2:
            fail(f"the rasterizer launches {per_call} kernels a call")
        # the bytes the call asks the allocator for (its cached blocks may
        # be larger): the image, the scratch of the faces, their int32 copy
        # and 64 KiB for the workspaces of the wrapper's index check (its
        # min and max), far below a byte a pixel (the first version asked
        # for 12 more)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        rasterize_mesh_cuda(*args)
        torch.cuda.synchronize()
        extra = (torch.cuda.memory_stats()["requested_bytes.all.peak"]
                 - before)
        n_f = faces.shape[0]
        allowed = (image.numel() * 8 + n_f * FACE_BYTES
                   + -(-n_f // 32) * GROUP_BYTES + n_f * 12 + 65536)
        if extra > allowed:
            fail(f"a rasterizer call at {w}x{h} asks for {extra} bytes, "
                 f"more than the image, the face scratch, the faces' copy "
                 f"and 64 KiB ({allowed})")
        plain_ms = eager_ms(lambda: rasterize_mesh_plain(*args), calls=3,
                            warmup=1)
        n_v = px.shape[0]
        nbytes = (n_v * (2 + 1 + 3) * 8 + faces.numel() * 8
                  + 2 * image.numel() * 8)
        ops = (box_px * RASTER_OPS_PER_BOX_PIXEL
               + covered * RASTER_OPS_PER_COVERED_PIXEL)
        bound, by = bound_ms(nbytes, ops, kind, f64=True)
        geometry = choose_geometry(h, w, _sm_count(dev.index or 0))
        print(f"[rasterize] {w}x{h}, geometry {geometry}: eager {ms:.4f} "
              f"ms/call, device {dev_ms:.4f} ms (profiler, {per_call:g} "
              "kernels a call), "
              f"{extra} bytes requested a call, plain twin "
              f"{plain_ms:.2f} ms, bound {bound * 1e3:.2f} us by {by} "
              f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} Mop f64), "
              f"{100 * bound / dev_ms:.1f} % of bound on device time")
        if row is None:
            row = {"name": "rasterize", "route": "cuda",
                   "source": "lighthand_tpu_torch/csrc/rasterize.cu",
                   "replaces": "lighthand_tpu/utils/mesh_render.py:119",
                   "launches": launches["rasterize"],
                   "launches_by_path": {"render": launches["rasterize"]},
                   "max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms,
                   "kernels_a_call": per_call, "geometry": geometry,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None, "shape": f"{w}x{h}, {len(f)} faces"}
        else:
            row["at_224"] = {"ms": ms, "device_ms": dev_ms,
                             "kernels_a_call": per_call, "geometry": geometry,
                             "plain_ms": plain_ms, "bound_ms": bound}
    return row, launches


# the CPU tests' tolerances (tests/test_torch_geometry.py)
GEOMETRY_RTOL, GEOMETRY_ATOL = 1e-5, 1e-6
PROCRUSTES_ATOL = 1e-4


def geometry_phase() -> None:
    """Phase 9f: ``ops/geometry.py`` and ``ops/procrustes.py`` on CUDA
    tensors against the same calls on the CPU, within the CPU tests'
    tolerances."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops import geometry as g
    from lighthand_tpu_torch.ops import procrustes as p

    rng = np.random.default_rng(12)
    cam = rng.normal(size=(21, 3)).astype(np.float32)
    cam[:, 2] += 5
    r = rng.normal(size=(3, 3)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    theta = rng.normal(size=(8, 3)).astype(np.float32)
    quat = rng.normal(size=(8, 4)).astype(np.float32)
    pts = rng.normal(size=(4, 21, 3)).astype(np.float32)
    scale_t = rng.normal(size=(4, 3)).astype(np.float32)
    euler = np.array([10.0, -20.0, 35.0], np.float32)
    s1 = rng.normal(size=(16, 21, 3)).astype(np.float32)
    s2 = (s1 @ np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
          * 1.3 + rng.normal(size=s1.shape).astype(np.float32) * 0.1)
    calls = {
        "cam2pixel": lambda d: g.cam2pixel(d(cam), (500.0, 510.0),
                                           (112.0, 100.0)),
        "pixel2cam": lambda d: g.pixel2cam(d(cam), (500.0, 510.0),
                                           (112.0, 100.0)),
        "world2cam": lambda d: g.world2cam(d(cam.T), d(r), d(t)),
        "rodrigues": lambda d: g.rodrigues(d(theta)),
        "quat2mat": lambda d: g.quat2mat(d(quat)),
        "orthographic_projection": lambda d: g.orthographic_projection(
            d(pts), d(scale_t)),
        "euler_to_rotation": lambda d: g.euler_to_rotation(d(euler)),
        "camera_calibration": lambda d: g.camera_calibration(
            d(cam), d(euler), d(t - [0, 0, 10]), 500.0, (112.0, 112.0)),
        "compute_similarity_transform":
            lambda d: p.compute_similarity_transform(d(s1[0]), d(s2[0])),
        "reconstruction_error": lambda d: p.reconstruction_error(
            d(s1), d(s2), "none"),
    }
    errs = {}
    for name, call in calls.items():
        want = call(torch.from_numpy)
        got = call(lambda a: torch.from_numpy(np.ascontiguousarray(a))
                   .cuda())
        if got.device.type != "cuda":
            fail(f"{name} left the card: {got.device}")
        got = got.cpu()
        errs[name] = float((got - want).abs().max())
        if name in ("compute_similarity_transform", "reconstruction_error"):
            ok = errs[name] <= PROCRUSTES_ATOL
        else:
            ok = bool(torch.allclose(got, want, rtol=GEOMETRY_RTOL,
                                     atol=GEOMETRY_ATOL))
        if got.shape != want.shape or not ok:
            fail(f"{name} on the card differs from the CPU: {errs[name]}")
    print(f"[geometry] card vs CPU max|diff| (geometry rtol "
          f"{GEOMETRY_RTOL:g} + atol {GEOMETRY_ATOL:g}, procrustes atol "
          f"{PROCRUSTES_ATOL:g}): {errs}")


def int8_times(kind: str, shape, seed: int) -> tuple:
    """Phase 8b at one conv shape, batch 32, bf16 activations (the int8_fwd
    policy's): for the conv and for the weight kernel, the eager and device
    time (CUDA graph replay), the twin's time and the bound; for the conv
    also the time of ``torch._int_mm`` on the pre-quantized im2col of the
    same operands, K zero-padded to a multiple of 8 in both (the GEMM
    alone, the same sums; checked equal to the kernel), and of cuDNN's bf16
    conv of the shape, which the bf16 policy runs. Returns (conv figures,
    weight kernel figures)."""
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
    pad = k // 2
    x, wt = int8_inputs(B_TRAIN, shape, seed)
    w_q, _, scale = quantize_weight_cuda(wt, ACT_CLIP)
    fn = lambda: int8_conv2d_cuda(x, w_q, scale, ACT_CLIP, stride,  # noqa
                                  pad)
    ms = eager_ms(fn)
    graph = capture(fn)
    dev_ms, how = device_ms(fn, graph)
    del graph
    plain_ms = eager_ms(lambda: int8_twin(x, w_q, scale, stride, pad,
                                          torch.bfloat16), calls=5)
    ho, wo = out_size(h, k, stride, pad), out_size(w, k, stride, pad)
    m = B_TRAIN * ho * wo
    ops = conv_ops(B_TRAIN, shape)
    # bf16 activations in, s8 weights and f32 scales, bf16 out
    nbytes = 2 * x.numel() + w_q.numel() + 4 * cout + 2 * m * cout
    bound, by = bound_ms(nbytes, ops, kind, int8=True)

    kk = cin * k * k
    kp = -(-kk // 8) * 8  # K padded with zeros: _int_mm takes K % 8 == 0
    library_ms = lib_dev = None
    if cout % 8 == 0 and m > 16:
        x_q = quantize_activation(x, ACT_CLIP)
        cols = F.unfold(x_q.float(), k, padding=pad, stride=stride)
        a = torch.zeros((m, kp), dtype=torch.int8, device=x.device)
        a[:, :kk] = cols.transpose(1, 2).reshape(m, kk).to(torch.int8)
        del cols, x_q
        b = torch.zeros((cout, kp), dtype=torch.int8, device=x.device)
        b[:, :kk] = w_q.permute(0, 3, 1, 2).reshape(cout, kk)
        b = b.t()
        try:
            acc = torch._int_mm(a, b)
        except RuntimeError as exc:  # a yardstick only; the port never calls it
            print(f"note: torch._int_mm refused {shape} (K {kk} -> {kp}): "
                  f"{exc}")
        else:
            ref = (acc.float() * scale).to(torch.bfloat16)
            got = fn().permute(0, 2, 3, 1).reshape(m, cout)
            if not torch.equal(ref, got):
                fail(f"torch._int_mm and the int8 kernel disagree at {shape}")
            library_ms = eager_ms(lambda: torch._int_mm(a, b))
            graph = capture(lambda: torch._int_mm(a, b))
            lib_dev, _ = device_ms(lambda: torch._int_mm(a, b), graph)
            del graph, acc, ref
        del a, b
    x16 = x.contiguous(memory_format=torch.channels_last)
    w16 = wt.to(torch.bfloat16)
    conv = lambda: F.conv2d(x16, w16, None, stride, pad)  # noqa: E731
    cudnn_ms = eager_ms(conv)
    graph = capture(conv)
    cudnn_dev, _ = device_ms(conv, graph)
    del graph
    plan = conv_plan(x, w_q, stride, pad)
    print(f"[int8_conv] N={B_TRAIN} Cin={cin} {h}x{w} Cout={cout} k={k} "
          f"s={stride} {plan}: eager {ms:.4f} ms, device {dev_ms:.4f} ms "
          f"({how}), plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by "
          f"{by} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} Gop), "
          f"{100 * bound / dev_ms:.1f} % of bound; torch._int_mm "
          + (f"(K {kk} -> {kp}) {library_ms:.4f} ms eager, {lib_dev:.4f} "
             "ms device" if library_ms is not None else "not timed")
          + f"; cuDNN bf16 conv {cudnn_ms:.4f} ms eager, {cudnn_dev:.4f} ms "
          "device")
    conv_fig = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_dev,
                "library_eager_ms": library_ms, "cudnn_bf16_ms": cudnn_dev,
                "cudnn_bf16_eager_ms": cudnn_ms, "shape": list(shape),
                "plan": plan}

    wf = lambda: quantize_weight_cuda(wt, ACT_CLIP)  # noqa: E731
    w_ms = eager_ms(wf)
    graph = capture(wf)
    w_dev, w_how = device_ms(wf, graph)
    del graph
    w_plain = eager_ms(lambda: quantize_weight_plain(wt, ACT_CLIP))
    nw = wt.numel()
    # f32 in, s8 out, s_w and scale out; |w|, max, divide, round, clamp
    w_bytes, w_ops = 5 * nw + 8 * cout, WEIGHT_OPS_PER_VALUE * nw
    w_bound, w_by = bound_ms(w_bytes, w_ops, kind)
    print(f"[quantize_weight] {cout}x{cin}x{k}x{k}: eager {w_ms:.4f} ms, "
          f"device {w_dev:.4f} ms ({w_how}), plain {w_plain:.4f} ms, bound "
          f"{w_bound * 1e3:.3f} us by {w_by} ({w_bytes / 1e6:.2f} MB), "
          f"{100 * w_bound / w_dev:.1f} % of bound")
    weight_fig = {"ms": w_ms, "device_ms": w_dev, "plain_ms": w_plain,
                  "bound_ms": w_bound, "bound_by": w_by, "library_ms": None,
                  "shape": [cout, cin, k, k]}
    return conv_fig, weight_fig


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


def grouped_times(kind: str) -> dict:
    """Phase 8d, the grouped weight kernel over each whole model's weights
    (``model_quant_weights``, channels_last): eager ms (events around 20
    calls) and device ms (one call captured in a CUDA graph, replayed),
    its byte bound (5 bytes a weight, 8 a channel), the plain twin's ms, a
    call's host us; beside the per-conv launches of the same weights (a
    group of one each, a launch a conv as before the grouped kernel), eager
    and device ms of the loop over them. Returns {model: figures}."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        quantize_weight_cuda,
        quantize_weights_cuda,
        quantize_weights_plain,
    )

    out = {}
    for name in ("hrnet_w32", "resnet50"):
        ws = model_quant_weights(name, torch.channels_last)
        group = lambda: quantize_weights_cuda(ws, ACT_CLIP)  # noqa: E731
        per_conv = lambda: [quantize_weight_cuda(w, ACT_CLIP)  # noqa: E731
                            for w in ws]
        ms = eager_ms(group)
        dev_ms, how = device_ms(group, capture(group))
        per_ms = eager_ms(per_conv, calls=5)
        per_dev, _ = device_ms(per_conv, capture(per_conv), calls=5)
        plain_ms = eager_ms(lambda: quantize_weights_plain(ws, ACT_CLIP),
                            calls=3, warmup=1)
        values = sum(w.numel() for w in ws)
        channels = sum(w.shape[0] for w in ws)
        nbytes = 5 * values + 8 * channels
        bound, by = bound_ms(nbytes, WEIGHT_OPS_PER_VALUE * values, kind)
        host = host_us(group, calls=50)
        print(f"[quantize_weights] {name}: {len(ws)} weights, {values} "
              f"values, {channels} channels in one launch: eager {ms:.4f} "
              f"ms, device {dev_ms:.4f} ms ({how}), bound {bound * 1e3:.2f} "
              f"us by {by} ({nbytes / 1e6:.1f} MB), {100 * bound / dev_ms:.1f}"
              f" % of bound, plain {plain_ms:.4f} ms, host {host:.1f} us a "
              f"call; the same weights a launch a conv ({len(ws)} launches):"
              f" eager {per_ms:.4f} ms, device {per_dev:.4f} ms")
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "host_us": host, "per_conv_ms": per_ms,
                     "per_conv_device_ms": per_dev,
                     "shape": f"{name}: {len(ws)} weights, {values} values"}
        del ws
    return out


def quant_conv_breakdown(shapes: dict, grouped: dict) -> dict:
    """Phase 8d: a forward's quantized convs, every distinct shape of
    ResNet-50 and HRNet-W32 at batch 32 with bf16 activations: the device
    time (CUDA graph replay) of ``ops/quant.py:quant_forward`` with a
    conv's own weight quantize (a group of one, as a ``QuantConv2d`` called
    on its own) and of the conv alone, times the shape's uses, summed a
    forward, with each shape's plan; a forward's quantized convs are the
    convs alone and one grouped weight quantize (``grouped``, from
    ``grouped_times``). Then the host microseconds a call of
    ``quant_forward``, with its weights quantized already (as in a model's
    forward) and quantizing its own, and of a bf16 conv with its weight
    cast (4 x 32 x 16 x 16, 3x3), the host work a quantized conv adds to an
    eager forward."""
    import torch
    import torch.nn.functional as F

    from lighthand_tpu_torch.ops import quant
    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        quantize_weight_cuda,
    )

    result = {}
    for name, uses in sorted(shapes.items()):
        rows = []
        for shape, u in sorted(uses.items()):
            cin, h, w, cout, k, s = shape
            x, wt = int8_inputs(B_TRAIN, shape, 7)
            w_q, _, scale = quantize_weight_cuda(wt, ACT_CLIP)

            def whole():
                return quant.quant_forward(x, wt, s, k // 2, ACT_CLIP,
                                           torch.bfloat16)

            def conv():
                return int8_conv2d_cuda(x, w_q, scale, ACT_CLIP, s, k // 2)
            rows.append((shape, u, device_ms(whole, capture(whole))[0],
                         device_ms(conv, capture(conv))[0],
                         conv_plan(x, w_q, s, k // 2)))
            del x, wt, w_q, scale
        total = sum(u * ms for _, u, ms, _, _ in rows)
        conv_total = sum(u * ms for _, u, _, ms, _ in rows)
        forward = conv_total + grouped[name]["device_ms"]
        result[name] = {"quantized_conv_ms": forward, "conv_ms": conv_total,
                        "per_conv_quantize_ms": total}
        print(f"[int8 convs] {name} bs{B_TRAIN}: {forward:.4f} ms device "
              f"time a forward in quantized convs ({len(rows)} shapes, "
              f"{sum(u for _, u, _, _, _ in rows)} convs): the conv kernel "
              f"{conv_total:.4f} ms and one grouped weight quantize "
              f"{grouped[name]['device_ms']:.4f} ms; with a quantize a conv "
              f"{total:.4f} ms; the heaviest (shape x uses: ms a call with "
              "its quantize / conv, plan):")
        for shape, u, ms, c_ms, plan in sorted(
                rows, key=lambda r: -r[1] * r[2])[:6]:
            print(f"    {shape} x{u}: {ms:.4f} / {c_ms:.4f} ms {plan}")
    x = torch.randn(4, 32, 16, 16, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    wt = torch.randn(32, 32, 3, 3, device="cuda").contiguous(
        memory_format=torch.channels_last)
    made = quant.quantize_group([wt], ACT_CLIP)[0]
    result["host_us"] = {
        "quant_forward": host_us(lambda: quant.quant_forward(
            x, wt, 1, 1, ACT_CLIP, torch.bfloat16, made)),
        "quant_forward_own_quantize": host_us(lambda: quant.quant_forward(
            x, wt, 1, 1, ACT_CLIP, torch.bfloat16)),
        "bf16_cast_and_conv": host_us(lambda: F.conv2d(
            x, wt.to(torch.bfloat16), None, 1, 1))}
    print(f"[int8 convs] host us a call: {result['host_us']}")
    return result


def forward_times() -> None:
    """Phase 8c: the eval-mode forward of ResNet-50 and HRNet-W32 at bs32,
    256x256, under bf16 and under int8_fwd (the same random weights):
    CUDA events around 10 forwards after 3 warm-ups; then the profiler's
    device time of 3 forwards by kernel, its sum over the event time (the
    device's busy share), the kernels that take the most and the count of
    device kernels a forward, which must not be larger under int8_fwd (a
    quantized conv launches two kernels, the weight quantize and the conv;
    a bf16 conv launches a weight cast and cuDNN's conv)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import init_weights

    x = torch.randn(B_TRAIN, 3, SIZE, SIZE, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    for name in ("resnet50", "hrnet_w32"):
        times, launches = {}, {}
        for tag, policy in (("bf16", DTypePolicy()),
                            ("int8_fwd", DTypePolicy.int8_fwd())):
            model = get_model(name, policy=policy)
            init_weights(model, torch.Generator().manual_seed(0))
            model = model.eval().to("cuda", memory_format=torch.channels_last)
            with torch.no_grad():
                times[tag] = eager_ms(lambda: model(x), calls=10, warmup=3)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        model(x)
                    torch.cuda.synchronize()
            kernels = sorted(((e.self_device_time_total / 3e3, e.count // 3,
                               e.key) for e in prof.key_averages()
                              if e.self_device_time_total > 0), reverse=True)
            busy = sum(ms for ms, _, _ in kernels)
            launches[tag] = sum(n for _, n, _ in kernels)
            wq = sum(ms for ms, _, key in kernels if "quantize_weight" in key)
            print(f"[forward] {name} {tag}: {times[tag]:.3f} ms a forward "
                  f"(events), {busy:.3f} ms of kernels (profiler) = "
                  f"{100 * busy / times[tag]:.1f} % busy, {launches[tag]} "
                  f"device kernels a forward; weight quantize {wq:.3f} ms "
                  f"({100 * wq / times[tag]:.2f} % of the forward); top "
                  "kernels (ms a forward, launches): " + "; ".join(
                      f"{key[:48]} {ms:.3f} x{n}"
                      for ms, n, key in kernels[:6]))
        print(f"[forward] {name} bs{B_TRAIN} {SIZE}x{SIZE} eval: bf16 "
              f"{times['bf16']:.3f} ms, int8_fwd {times['int8_fwd']:.3f} ms "
              f"per forward; device kernels {launches}")
        if launches["int8_fwd"] > launches["bf16"]:
            fail(f"{name}: int8_fwd launches {launches['int8_fwd']} device "
                 f"kernels a forward, bf16 {launches['bf16']}")


# phase 10a's frozen parameters: the stem and layer1, by the reference's
# state_dict names (its freeze_weights matched the same names)
FREEZE = [r"^(conv1|bn1|conv2|bn2|layer1)\."]
# the tolerances of phase 10a's scores, card against CPU on the same
# heatmaps: soft-argmax in px, the losses relative; PCK values and the
# argmax decode must be equal
SOFT_ATOL_PX, SCORE_LOSS_RTOL = 1e-4, 1e-5


def _pck_margin(norm, thresholds) -> float:
    """The least |normalised distance - threshold| over the threshold, in
    f64: how far the scored inputs lie from a threshold."""
    import numpy as np

    norm = np.asarray(norm, np.float64).reshape(-1, 1)
    t = np.asarray(thresholds, np.float64).reshape(1, -1)
    return float((np.abs(norm - t) / t).min())


def finetune_phase(weights: dict, batch: dict, counters, card: str,
                   k1_step_ms: float, name: str = "hrnet_w32",
                   dev=None) -> tuple:
    """Phase 10a: fine-tuning with a frozen stem, then the full metric set.
    Phase 4's trained ``name`` (``weights``) in a state built with
    ``trainable=freeze_mask(model, FREEZE)``; 3 fused steps (K1 3, K2 0):
    every frozen parameter bit-equal to its start with no gradient, every
    trainable one moved, ``param_count`` unchanged; then the predict step,
    and its heatmaps scored on the card and on the CPU: ``get_max_preds``
    (equal), ``soft_argmax_preds`` (within SOFT_ATOL_PX), ``pck_2d``
    (proportion and mm), ``pck_2d_visible``, ``pck_curve`` over the offline
    eval's two grids, ``pck_3d`` on a lifted copy of the joints (all equal),
    ``keypoint_2d_loss`` and ``keypoint_3d_loss`` (within SCORE_LOSS_RTOL).
    Returns the steps' launches and the figures."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops import decode, metrics
    from lighthand_tpu_torch.ops.color import divide, normalize_imagenet
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
        make_predict_step,
    )
    from lighthand_tpu_torch.train.state import param_count
    from lighthand_tpu_torch.utils.misc import freeze_mask

    dev = dev or torch.device("cuda")
    model = get_model(name)
    model.load_state_dict(weights)
    mask = freeze_mask(model, FREEZE)
    state = create_train_state(model, lr=1e-3, device=dev, trainable=mask)
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    n_params = param_count(state)
    step = make_fused_train_step(scan_steps=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    zero(counters)
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, out = step(state, gen, batch)
        losses.append(float(out["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
    counts = read(counters)
    want = {"fused_aug_targets": 3, "heatmap_targets": 0, "int8_conv": 0,
            "quantize_weight": 0}
    if counts != want:
        fail(f"the fine-tune steps launched {counts}, expected {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite fine-tune losses: {losses}")
    frozen = [k for k, v in mask.items() if not v]
    for k, p in state.model.named_parameters():
        same = torch.equal(p.detach(), start[k])
        if not mask[k] and not (same and p.grad is None
                                and not p.requires_grad):
            fail(f"frozen parameter {k} changed or holds a gradient")
        if mask[k] and same:
            fail(f"trainable parameter {k} did not move")
    if param_count(state) != n_params:
        fail(f"param_count moved: {n_params} -> {param_count(state)}")
    ms_step = statistics.median(step_s[1:]) * 1e3
    n_frozen = sum(start[k].numel() for k in frozen)
    print(f"[finetune] {name} 256x256 bs{B_TRAIN} bf16, {len(frozen)} of "
          f"{len(mask)} parameters frozen ({n_frozen} of {n_params} "
          f"elements): losses {losses}; step ms "
          f"{[round(s * 1e3, 2) for s in step_s]}; steady {ms_step:.2f} "
          f"ms/step against phase 4's {k1_step_ms:.2f} on {card}; "
          f"launches {counts}; frozen bit-equal with no gradient, every "
          "trainable parameter moved")

    # the predict step, then its heatmaps scored on the card and the CPU
    images = normalize_imagenet(divide(batch["image_u8"].float(), 255.0))
    joints_px, _ = make_predict_step(device=dev)(state, images)
    with torch.no_grad():
        hm = state.model(images.permute(0, 3, 1, 2)).float()
    rng = np.random.default_rng(11)
    gt = batch["joints"]
    b, j = gt.shape[:2]
    vis = torch.from_numpy((rng.uniform(size=(b, j, 1)) > 0.25)
                           .astype(np.float32)).to(dev)
    depth = torch.from_numpy(rng.uniform(-40, 40, size=(b, j, 1))
                             .astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.normal(scale=4.0, size=(b, j, 3))
                             .astype(np.float32)).to(dev)
    grids = {"proportion": np.linspace(0.1, 0.3, 100),  # pckb [0.1, 0.3]
             "mm": np.linspace(0, 30, 101)[1:] * metrics.MM_THRESH_SCALE_EVAL}

    def scores(hm, gt, vis, depth, noise):
        preds, maxvals = decode.get_max_preds(hm)
        px = preds * 4.0
        soft, conf = decode.soft_argmax_preds(hm)
        gt_v = torch.cat([gt, vis], dim=-1)
        gt3 = torch.cat([gt, depth], dim=-1)  # the joints, lifted
        pred3 = gt3 + noise
        return {
            "argmax": preds, "maxvals": maxvals, "soft": soft, "conf": conf,
            "pck_2d": metrics.pck_2d(px, gt, 0.2),
            "pck_2d_mm": metrics.pck_2d(px, gt, 20.0, "mm"),
            "pck_2d_visible": metrics.pck_2d_visible(px, gt_v, 0.2),
            **{f"pck_curve_{k}": metrics.pck_curve(px, gt, torch.tensor(
                g, dtype=torch.float32), k) for k, g in grids.items()},
            "pck_3d": metrics.pck_3d(pred3, gt3, 20.0)[0],
            "keypoint_2d_loss": metrics.keypoint_2d_loss(px, gt_v),
            "keypoint_3d_loss": metrics.keypoint_3d_loss(pred3, gt3)}

    card_s = {k: v.cpu() for k, v in
              scores(hm, gt, vis, depth, noise).items()}
    cpu_s = scores(*(x.cpu() for x in (hm, gt, vis, depth, noise)))
    if not torch.equal(joints_px.cpu(), card_s["argmax"] * 4.0):
        fail("the predict step's joints are not its heatmaps' argmax")
    soft_err = float((card_s["soft"] - cpu_s["soft"]).abs().max())
    loss_err = {k: abs(float(card_s[k]) / float(cpu_s[k]) - 1.0)
                for k in ("keypoint_2d_loss", "keypoint_3d_loss")}
    unequal = [k for k, v in card_s.items() if k not in ("soft", *loss_err)
               and not torch.equal(v, cpu_s[k])]
    dist = (gt.cpu().double() - cpu_s["argmax"] * 4.0).norm(dim=-1)
    diag = metrics.bbox_diagonal(gt.cpu()).double()[:, None]
    margin = min(_pck_margin(dist / diag, [0.2]),
                 _pck_margin(dist, [20.0 * metrics.MM_SCALE_PCK]),
                 _pck_margin(dist / diag, grids["proportion"]),
                 _pck_margin(dist / metrics.MM_SCALE_PCK, grids["mm"]))
    pck = {k: round(float(card_s[k]), 6) for k in
           ("pck_2d", "pck_2d_mm", "pck_2d_visible", "pck_3d")}
    pck.update({f"{k}[first,last]": [round(float(card_s[k][0]), 4),
                                     round(float(card_s[k][-1]), 4)]
                for k in ("pck_curve_proportion", "pck_curve_mm")})
    print(f"[finetune] scores card vs CPU on the same heatmaps: unequal "
          f"{unequal}; soft-argmax max|diff| {soft_err:.3g} px (atol "
          f"{SOFT_ATOL_PX:g}); losses relative {loss_err} (rtol "
          f"{SCORE_LOSS_RTOL:g}); least relative margin of a distance to a "
          f"threshold {margin:.3g}; PCK {pck}")
    if unequal or not soft_err <= SOFT_ATOL_PX or not all(
            e <= SCORE_LOSS_RTOL for e in loss_err.values()):
        fail("the scores on the card disagree with the CPU's")
    if not all(math.isfinite(float(v)) for k, v in card_s.items()
               if v.ndim == 0):
        fail("non-finite scores")
    return counts, {"step_ms": ms_step, "pck": pck}


def single_target_phase(counters, dev=None) -> tuple:
    """Phase 10b: ``generate_target`` (one sample) on CUDA joints, through
    K2 with B=1: J=21, H=64, stride 4, [J, 2] joints, and H=50, stride 3.0,
    [J, 3] joints with one joint off the map. Each call launches K2 once;
    its maps within F32_ATOL of the plain twin on the card and of the CPU's,
    its weights equal to the CPU's, the off-map joint's 0. Returns the
    launches and the largest error."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops.heatmap import (
        generate_target,
        generate_target_batch,
    )
    from lighthand_tpu_torch.ops.kernels.heatmap import (
        generate_target_batch_cuda,
    )

    dev = dev or torch.device("cuda")
    rng = np.random.default_rng(21)
    zero(counters)
    worst = 0.0
    for hm, stride, cols in ((HM, 4.0, 2), (50, 3.0, 3)):
        joints = rng.uniform(0, hm * stride, size=(JOINTS, cols)).astype(
            np.float32)
        joints[3, :2] = [-80.0, hm * stride + 200.0]  # off the map
        joints = torch.from_numpy(joints).to(dev)
        before = generate_target_batch_cuda.launches
        maps, weight = generate_target(joints, heatmap_size=hm, stride=stride,
                                       return_weight=True)
        launched = generate_target_batch_cuda.launches - before
        twin = generate_target_batch(joints[None], hm, stride)[0]
        cpu_maps, cpu_weight = generate_target(
            joints.cpu(), heatmap_size=hm, stride=stride, return_weight=True)
        err = max(float((maps - twin).abs().max()),
                  float((maps.cpu() - cpu_maps).abs().max()))
        print(f"[target] J={JOINTS} H={hm} stride {stride} joints [J, "
              f"{cols}]: K2 launches {launched}; max|kernel - plain| "
              f"{err:.3g} (atol {F32_ATOL:g}); weights "
              f"{weight.cpu().int().tolist()}")
        if (maps.shape != (JOINTS, hm, hm) or launched != 1
                or not err <= F32_ATOL
                or not torch.equal(weight.cpu(), cpu_weight)
                or float(weight[3]) != 0.0 or float(weight.sum()) < 10):
            fail(f"generate_target on the card is wrong at H={hm}")
        worst = max(worst, err)
    return read(counters), worst


def preprocessor_phase(counters, card: str, dev=None) -> dict:
    """Phase 10c: ``DevicePreprocessor(jitter=True)`` on a u8 bs32 256x256
    batch on the card and on the CPU with the same injected draws (CPU
    ``draw_jitter``, every op order): f32 outputs within CHAIN_IMAGE_ATOL in
    normalised units (the chain's bound: the same jitter and normalize,
    each image's contrast mean summed in another order); no kernel
    launches; the default bf16 call with its own draws from a generator on
    the card; device ms of that call (the profiler's kernel sum) beside
    K1's at the same batch. Returns the figures."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.data import DevicePreprocessor
    from lighthand_tpu_torch.ops.color import draw_jitter
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        fused_aug_targets_cuda,
    )

    dev = dev or torch.device("cuda")
    rng = np.random.default_rng(31)
    images = torch.from_numpy(rng.integers(
        0, 256, size=(B_TRAIN, SIZE, SIZE, 3), dtype=np.uint8)).to(dev)
    aug = torch.from_numpy((np.arange(B_TRAIN) % 4 != 3)
                           .astype(np.float32)).to(dev)
    factors, order = draw_jitter(torch.Generator().manual_seed(32), B_TRAIN)
    perms = list(itertools.permutations(range(4)))
    order = torch.tensor([perms[i % 24] for i in range(B_TRAIN)])
    zero(counters)
    card_pre = DevicePreprocessor(out_dtype=torch.float32, device=dev)
    got = card_pre(images, aug, factors=factors, order=order)
    bf16 = DevicePreprocessor(device=dev)(
        images, aug, torch.Generator(device=dev).manual_seed(33))
    counts = read(counters)
    want = DevicePreprocessor(out_dtype=torch.float32, device="cpu")(
        images.cpu(), aug.cpu(), factors=factors, order=order)
    err = float((got.cpu() - want).abs().max())
    print(f"[preprocess] DevicePreprocessor(jitter=True) B={B_TRAIN} "
          f"{SIZE}x{SIZE} card vs CPU, same draws: max|diff| {err:.3g} "
          f"(atol {CHAIN_IMAGE_ATOL:g}, normalised units); launches "
          f"{counts}; bf16 call {bf16.dtype} {tuple(bf16.shape)}")
    if (got.shape != (B_TRAIN, SIZE, SIZE, 3) or not err <= CHAIN_IMAGE_ATOL
            or any(counts.values()) or bf16.dtype != torch.bfloat16
            or not torch.isfinite(bf16.float()).all()):
        fail("DevicePreprocessor on the card disagrees with the CPU")
    pre = DevicePreprocessor(device=dev)
    factors, order = factors.to(dev), order.to(dev)
    k1_images, k1_joints, params = k1_inputs(B_TRAIN, 34, device=dev)

    def plain():
        return pre(images, aug, factors=factors, order=order)

    def k1():
        return fused_aug_targets_cuda(k1_images, k1_joints, params)

    figures = {}
    for tag, fn, graph in (("preprocessor", plain, None),
                           ("K1", k1, capture(k1))):
        figures[f"{tag}_eager_ms"] = eager_ms(fn)
        figures[f"{tag}_device_ms"], how = device_ms(fn, graph)
        print(f"[preprocess] {tag} B={B_TRAIN} {SIZE}x{SIZE} bf16: eager "
              f"{figures[f'{tag}_eager_ms']:.4f} ms, device "
              f"{figures[f'{tag}_device_ms']:.4f} ms ({how}) on {card}")
    return figures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops.color import normalize_imagenet
    from lighthand_tpu_torch.ops.heatmap import generate_target_batch
    from lighthand_tpu_torch.ops.kernels import _build
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        count_div_mismatches,
        fused_aug_targets_cuda,
        fused_aug_targets_plain,
        launch_geometry,
    )
    from lighthand_tpu_torch.ops.kernels.heatmap import (
        generate_target_batch_cuda,
    )
    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        int8_conv2d_cuda,
        quantize_weights_cuda,
    )
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_fused_train_step,
        make_predict_step,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # 1. device and build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    missing = [n for n in _build.SOURCES + _build.HOST_SOURCES
               if not _build.library_path(n).exists()]
    if missing:
        fail(f"libraries not built: {missing}")

    # 1b. the host image codec against cv2's stored results ---------------
    codec_ms = codec_phase()

    # 2. K2 against its plain twin -----------------------------------------
    rng = np.random.default_rng(0)
    k2_err = 0.0
    for b, hm, stride, cols in ((B_KERNEL, HM, 4.0, 2), (B_TRAIN, HM, 4.0, 2),
                                (5, 50, 3.0, 3)):
        joints = torch.from_numpy(rng.uniform(-40, 300, size=(b, JOINTS, cols))
                                  .astype(np.float32)).to(dev)
        got = generate_target_batch_cuda(joints, hm, stride)
        want = generate_target_batch(joints, hm, stride)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[K2] B={b} hm={hm} stride={stride} joints [B, J, {cols}]: "
              f"max|kernel - plain| = {err:.3g} (atol 1e-5)")
        if got.shape != want.shape or not err <= 1e-5:
            fail(f"K2 disagrees with its plain twin at B={b}, hm={hm}: {err}")
        k2_err = max(k2_err, err)

    # 3. K1 against its plain twin -----------------------------------------
    mismatches = count_div_mismatches(dev)
    print(f"[K1] normalize's division: {mismatches} of its 3 x "
          "1,065,353,217 numerators differ from IEEE division")
    if mismatches:
        fail("K1's constant division differs from IEEE division")
    k1_err = 0.0
    ragged_order = [[-1, 5, 1, 1], [1, 2, 5, 1], [3, 0, 2, 1]]
    k1_cases = (
        # (B, seed, H, W, joint columns, op orders, hm, stride, joints)
        (B_KERNEL, 1, SIZE, SIZE, 2, None, HM, 4.0, JOINTS),
        (B_TRAIN, 2, SIZE, SIZE, 2, None, HM, 4.0, JOINTS),
        (3, 5, 97, 131, 3, ragged_order, 50, 3.0, JOINTS),
        (2, 6, 300, 300, 2, None, HM, 4.0, JOINTS),
        (2, 7, 16, 16, 2, None, 16, 1.0, 40),  # one block, 40 maps
        # above 16 x 1024 x 8 pixels: threads walk 2 and 4 pixel groups
        (2, 8, 384, 384, 2, None, HM, 4.0, JOINTS),
        (2, 9, 517, 771, 2, ragged_order[:2], HM, 4.0, JOINTS),
    )
    for b, seed, h, w, cols, order, hm, stride, nj in k1_cases:
        images, joints, params = k1_inputs(b, seed, h, w, cols, order, nj)
        kw = {"heatmap_size": hm, "stride": stride}
        got_img, got_hm = fused_aug_targets_cuda(images, joints, params, **kw)
        want_img, want_hm = fused_aug_targets_plain(images, joints, params,
                                                    **kw)
        torch.cuda.synchronize()
        g, w_ = got_img.float(), want_img.float()
        diff = (g - w_).abs()
        ulp = bf16_ulp(w_)
        fine = ulp < F32_ATOL
        ulps = float((diff / ulp * ~fine).max())
        near0 = float((diff * fine).max())
        equal = float((diff == 0).float().mean())
        hm_err = float((got_hm - want_hm).abs().max())
        tag = f"B={b} {h}x{w} hm={hm} J={nj} {launch_geometry(h, w)}"
        print(f"[K1] {tag} bf16: max|diff| {float(diff.max()):.3g}, "
              f"{ulps:.3g} ulp where a ulp >= {F32_ATOL:g}, {near0:.3g} "
              f"below; equal {100 * equal:.4f} %; targets {hm_err:.3g}")
        if not (got_img.shape == want_img.shape and ulps <= 1.0
                and near0 <= F32_ATOL and equal >= 0.999 and hm_err <= 1e-5):
            fail(f"K1 disagrees with its plain twin at {tag}")
        k1_err = max(k1_err, float(diff.max()), hm_err)
        if b != B_KERNEL:
            got32, _ = fused_aug_targets_cuda(images, joints, params,
                                              out_dtype=torch.float32, **kw)
            want32, _ = fused_aug_targets_plain(images, joints, params,
                                                out_dtype=torch.float32, **kw)
            err32 = float((got32 - want32).abs().max())
            print(f"[K1] {tag} f32: max|diff| {err32:.3g} "
                  f"(atol {F32_ATOL:g})")
            if not err32 <= F32_ATOL:
                fail(f"K1 f32 variant disagrees with its plain twin at {tag}: "
                     f"{err32}")

    # 2b. the int8 conv against its plain twin ----------------------------
    shapes = {name: quant_conv_shapes(name)
              for name in ("resnet50", "hrnet_w32")}
    n_quant = {name: sum(uses.values()) for name, uses in shapes.items()}
    print(f"[int8] quantized convs: {n_quant}; distinct shapes: "
          f"{ {name: len(uses) for name, uses in shapes.items()} }")
    if n_quant != {"resnet50": 53, "hrnet_w32": 292}:
        fail(f"quantized conv counts {n_quant}, expected 53 and 292")
    weight_err, int8_err = int8_check_phase(shapes)
    weight_err = max(weight_err, grouped_check_phase())
    # 2c. fault 3: the weight scale on the card is the CPU's
    quant_module_phase()
    counters = {"fused_aug_targets": fused_aug_targets_cuda,
                "heatmap_targets": generate_target_batch_cuda,
                "int8_conv": int8_conv2d_cuda,
                "quantize_weight": quantize_weights_cuda}

    # 4. main path: train ---------------------------------------------------
    rng = np.random.default_rng(3)
    batch = {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=(B_TRAIN, SIZE, SIZE, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            16, SIZE - 16, size=(B_TRAIN, JOINTS, 2)).astype(np.float32)),
        "aug_enabled": torch.from_numpy(
            (np.arange(B_TRAIN) % 2).astype(np.float32)),
        "noise_enabled": torch.from_numpy(
            (np.arange(B_TRAIN) % 4 == 1).astype(np.float32)),
    }
    batch = {k: v.to(dev) for k, v in batch.items()}
    state = create_train_state(get_model("hrnet_w32"),
                               torch.Generator().manual_seed(0), lr=1e-3)
    step = make_fused_train_step(scan_steps=1)
    gen = torch.Generator(device=dev).manual_seed(1)

    zero(counters)
    losses, step_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))  # synchronises
        step_s.append(time.perf_counter() - t0)
    ms_step = statistics.median(step_s[1:]) * 1e3
    print(f"[train] HRNet-W32 256x256 bs{B_TRAIN} bf16: losses {losses}; "
          f"step ms {[round(s * 1e3, 2) for s in step_s]}; steady "
          f"{ms_step:.2f} ms/step = {B_TRAIN / ms_step * 1e3:.1f} img/s")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite train loss: {losses}")

    # 5. main path: eval + predict -----------------------------------------
    images = normalize_imagenet(batch["image_u8"].float() / 255.0)
    valid = torch.ones(B_TRAIN, device=dev)
    valid[-4:] = 0.0
    eval_batch = {"image": images, "joints": batch["joints"], "valid": valid}
    eval_step = make_eval_step()
    eval_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = eval_step(state, eval_batch)
        torch.cuda.synchronize()
        eval_s.append(time.perf_counter() - t0)
    joints_px, maxvals = make_predict_step()(state, images)
    torch.cuda.synchronize()
    launches = read(counters)
    scalars = {k: float(v) for k, v in out.items() if v.ndim == 0}
    print(f"[eval] {scalars}; eval ms {[round(s * 1e3, 2) for s in eval_s]}"
          f" = {B_TRAIN / eval_s[-1]:.1f} img/s")
    print(f"[path] launches {launches}")
    if launches["fused_aug_targets"] != 3:
        fail(f"K1 launched {launches['fused_aug_targets']} times in 3 steps")
    if launches["heatmap_targets"] < 1:
        fail("the eval step did not launch K2")
    if launches["int8_conv"] or launches["quantize_weight"]:
        fail("the bf16 path launched an int8 kernel")
    if scalars["n_valid"] != 28.0 or not all(map(math.isfinite,
                                                  scalars.values())):
        fail(f"bad eval metrics: {scalars}")
    if (tuple(out["pred_joints"].shape) != (B_TRAIN, JOINTS, 2)
            or tuple(joints_px.shape) != (B_TRAIN, JOINTS, 2)
            or not torch.isfinite(joints_px).all()
            or not torch.isfinite(maxvals).all()):
        fail("bad predict output")

    # phase 4's trained weights, for phase 10a (6c trains ``state`` on)
    w32_weights = {k: v.detach().clone()
                   for k, v in state.model.state_dict().items()}

    # 4b-5b. the int8_fwd policy: training, then serving phase 4's weights
    int8_launches = int8_train_phase(batch, counters, n_quant["hrnet_w32"])
    serve_launches = int8_serving_phase(state, images, counters,
                                        n_quant["hrnet_w32"])

    # 4c. the flip / rotation route: the chain and K2 instead of K1
    aug_launches, aug_fig, aug_k2_err = aug_route_phase(counters, card,
                                                        ms_step)

    # 6. the training entry point -------------------------------------------
    cli_launches, synth_fig = cli_phase(counters)

    # 6b-6d. the real-data path: a LightHand tree through the CLI, then a
    # FreiHAND TSV tree and a GAN + LightHand mix through fused steps, then
    # the eval entry point on 6b's run over an Armo tree
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        real_launches, real_fig = real_tree_phase(counters, tmp)
        mix_launches = frei_and_mix_phase(state, counters, tmp)
        eval_launches, eval_ips = eval_cli_phase(counters, tmp,
                                                 n_quant["resnet50"])
    # 6e-6f. the training CLI with --flip --rot-aug, then under the
    # environment contract at world size 1 (NCCL) against a plain run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aug_") as tmp:
        aug_cli_launches = aug_cli_phase(counters, tmp)
        dist_launches, dist_gaps, dist_ms = dist_phase(counters, tmp)
    # 9a-9f. the tree-making CLIs, JPEG writing, overlays, geometry
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as tmp:
        synth, tree_fig = synth_tree_phase(tmp)
        jpeg_ms = encode_phase(codec_ms)
        overlay_launches, overlay_fig = overlay_cli_phase(counters, tmp,
                                                          synth)
        plt_launches = plt_eval_phase(counters, tmp, synth)
        make_lighthand_phase(tmp)
    geometry_phase()
    # 9g-9h. the landmark and skeleton overlays; the mesh renderer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_draw_") as tmp:
        drawing_phase(tmp)
    raster_row, render_launches = render_phase(kind)
    # 10a-10c. fine-tuning with a frozen stem and the metric set; single
    # sample targets through K2; the jittering preprocessor
    ft_launches, ft_fig = finetune_phase(w32_weights, batch, counters, card,
                                         ms_step)
    del w32_weights
    target_launches, target_err = single_target_phase(counters)
    pre_fig = preprocessor_phase(counters, card)
    print(f"[figures] {card}: make_synth_data {tree_fig['img_s']:.1f} img/s "
          f"(host); JPEG ms {jpeg_ms}; overlay CLI (ResNet-50 bs{B_TRAIN}, "
          f"64 train images, 1 epoch) epoch {overlay_fig['epoch_s']:.2f} s, "
          f"host ms per overlay {overlay_fig['overlay_ms']}")
    print(f"[figures] {card}: flip + rotation 15 (phase 4c): HRNet-W32 "
          f"bs{B_TRAIN} step {aug_fig['step_ms']:.2f} ms against K1's "
          f"{aug_fig['k1_step_ms']:.2f} ms; at B={B_KERNEL} the chain "
          f"{aug_fig['chain_device_ms']:.4f} ms device "
          f"({aug_fig['chain_eager_ms']:.4f} ms eager) against K1's "
          f"{aug_fig['K1_device_ms']:.4f} ms ({aug_fig['K1_eager_ms']:.4f} "
          f"ms eager); world-size-1 NCCL run against the plain run "
          f"(ResNet-50 f32, 1 epoch): relative loss gaps {dist_gaps}; "
          f"HRNet-W32 bs{B_TRAIN} bf16 step plain {dist_ms['plain']:.2f} ms, "
          f"on a 1 x 1 mesh {dist_ms['mesh']:.2f} ms (Adam alone "
          f"{dist_ms['plain_adam']:.2f} / {dist_ms['mesh_adam']:.2f} ms)")
    print(f"[figures] {card}: fine-tune (phase 10a): HRNet-W32 "
          f"bs{B_TRAIN} step with the stem and layer1 frozen "
          f"{ft_fig['step_ms']:.2f} ms against phase 4's {ms_step:.2f} ms; "
          f"PCK {ft_fig['pck']}; DevicePreprocessor(jitter=True) (phase "
          f"10c) B={B_TRAIN} {pre_fig['preprocessor_device_ms']:.4f} ms "
          f"device ({pre_fig['preprocessor_eager_ms']:.4f} ms eager) "
          f"against K1's {pre_fig['K1_device_ms']:.4f} ms "
          f"({pre_fig['K1_eager_ms']:.4f} ms eager)")
    print(f"[figures] {card}: epoch wall s and img/s (bs{B_TRAIN}, 128 "
          f"train images, SimpleBaseline ResNet-50, bf16; overlays on, a "
          f"predict step and a JPEG at 3 train and up to 3 val iterations "
          f"an epoch, in 6, 6b and 6e too): synthetic "
          f"{synth_fig['epoch_s']} / {synth_fig['img_s']}; LightHand tree "
          f"of fixture JPEGs {real_fig['epoch_s']} / {real_fig['img_s']}; "
          f"host codec ms {codec_ms}; eval CLI img/s (ResNet-50, 64 Armo "
          f"images) {eval_ips}")

    # 7. reference: the trained weights in f32, card vs CPU, with both TF32
    # switches on outside the f32 policy's own context ---------------------
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    f32 = DTypePolicy.full_precision()
    cpu_model = get_model("hrnet_w32", policy=f32).eval()
    cpu_model.load_state_dict(weights)
    gpu_model = get_model("hrnet_w32", policy=f32).eval()
    gpu_model.load_state_dict(weights)
    gpu_model.to(dev, memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 64, 64, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    with torch.no_grad():
        ref = cpu_model(x)
        with numerics(f32):
            got = gpu_model(x.to(dev)).cpu()
        got_bf16 = state.model.eval()(x.to(dev)).float().cpu()
    err = float((got - ref).abs().max())
    ok = bool(torch.allclose(got, ref, atol=2e-4, rtol=1e-3))
    rel16 = float((got_bf16 - ref).abs().max() / ref.abs().max())
    print(f"[reference] W32 f32 card vs CPU at 64x64, TF32 on outside the "
          f"f32 policy's context: max|diff| {err:.3g} (atol 2e-4, rtol 1e-3:"
          f" {ok}); bf16 card vs f32 CPU: max|diff| / max|ref| = "
          f"{rel16:.3g}")
    if not ok:
        fail("the port's W32 forward on the card disagrees with the CPU")
    # the phases from here on only time kernels, with f32 math full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 8. kernel times and bounds -------------------------------------------
    def cases(b, seed):
        """(name, source, replaces, kernel call, plain call, bytes, ops) at
        batch b: each input read once, each output written once."""
        images, joints, params = k1_inputs(b, seed)
        n_px, n_hm = b * SIZE * SIZE, b * JOINTS * HM * HM
        return (
            ("fused_aug_targets", "lighthand_tpu_torch/csrc/fused_aug.cu",
             "lighthand_tpu/ops/pallas/fused_aug.py:151",
             lambda: fused_aug_targets_cuda(images, joints, params),
             lambda: fused_aug_targets_plain(images, joints, params),
             n_px * 3 + params.numel() * 4 + joints.numel() * 4
             + n_px * 3 * 2 + n_hm * 4,
             n_px * K1_OPS_PER_PIXEL + n_hm * TARGET_OPS_PER_ELEMENT),
            ("heatmap_targets", "lighthand_tpu_torch/csrc/heatmap.cu",
             "lighthand_tpu/ops/pallas/heatmap.py:66",
             lambda: generate_target_batch_cuda(joints),
             lambda: generate_target_batch(joints),
             joints.numel() * 4 + n_hm * 4, n_hm * TARGET_OPS_PER_ELEMENT),
        )

    paths = {"steps": launches, "int8_steps": int8_launches,
             "int8_serving": serve_launches, "cli": cli_launches,
             "real_tree_cli": real_launches,
             "frei_and_mix_steps": mix_launches, "eval_cli": eval_launches,
             "aug_route_steps": aug_launches, "aug_route_cli": aug_cli_launches,
             "dist_cli_world1": dist_launches,
             "overlay_cli": overlay_launches, "plt_eval_cli": plt_launches,
             "finetune_steps": ft_launches,
             "single_sample_targets": target_launches}
    errs = {"fused_aug_targets": k1_err,
            "heatmap_targets": max(k2_err, aug_k2_err, target_err)}
    flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for b, seed in ((B_TRAIN, 2), (B_KERNEL, 1)):
        for name, src, replaces, fn, plain, nbytes, ops in cases(b, seed):
            ms, plain_ms = eager_ms(fn), eager_ms(plain)
            graph = capture(fn)
            dev_ms, how = device_ms(fn, graph)
            bound, by = bound_ms(nbytes, ops, kind)
            print(f"[{name}] B={b}: eager {ms:.4f} ms/call, device {dev_ms:.4f}"
                  f" ms ({how}), plain {plain_ms:.4f} ms, bound "
                  f"{bound * 1e3:.2f} us by {by} ({nbytes / 1e6:.1f} MB, "
                  f"{ops / 1e9:.2f} Gop), {100 * bound / dev_ms:.1f} % of "
                  f"bound on device time")
            if b == B_TRAIN:
                cold = flushed_ms(fn, flush_buf.zero_)
                cold_dev = ("not measured (no graph)" if graph is None else
                            f"{flushed_ms(graph.replay, flush_buf.zero_):.4f}"
                            " ms (cuda graph)")
                print(f"[{name}] B={b}, L2 flushed before each call: eager "
                      f"{cold:.4f} ms, device {cold_dev}")
            del graph
            if b == B_KERNEL:
                by_path = {p: c[name] for p, c in paths.items()}
                rows.append({
                    "name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    "max_abs_err": errs[name], "ms": ms, "device_ms": dev_ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": None})

    # 8b-8c. the two int8 kernels at the heaviest conv shape of each net,
    # and the nets' forward under bf16 and int8_fwd
    timed = {}
    for i, (name, uses) in enumerate(sorted(shapes.items())):
        heavy = max(uses, key=lambda key: conv_ops(B_TRAIN, key) * uses[key])
        print(f"[int8_conv] {name}'s heaviest shape (Cin, H, W, Cout, k, s)"
              f" {heavy}: {uses[heavy]} uses, "
              f"{conv_ops(B_TRAIN, heavy) * uses[heavy] / 1e9:.1f} Gop a "
              "forward at bs32")
        timed[name] = int8_times(kind, heavy, 900 + i)
    stem_figs = {}
    for i, (name, uses) in enumerate(sorted(shapes.items())):
        stem = next(key for key in uses if key[0] % 32)
        print(f"[int8_conv] {name}'s stem (Cin, H, W, Cout, k, s) {stem}: "
              f"{uses[stem]} use, {conv_ops(B_TRAIN, stem) / 1e9:.2f} Gop a "
              "forward at bs32")
        stem_figs[name], _ = int8_times(kind, stem, 910 + i)
    forward_times()
    grouped = grouped_times(kind)
    breakdown = quant_conv_breakdown(shapes, grouped)
    conv_row, _ = max(
        timed.values(), key=lambda t: conv_ops(B_TRAIN, t[0]["shape"]))
    weight_row = {**grouped["hrnet_w32"],
                  "resnet50": grouped["resnet50"],
                  "heaviest_shape": {name: fig for name, (_, fig)
                                     in timed.items()}}
    for name, fig, err, replaces in (
            ("int8_conv", conv_row, int8_err,
             "lighthand_tpu/ops/quant.py:54"),
            ("quantize_weight", weight_row, weight_err,
             "lighthand_tpu/ops/quant.py:45")):
        by_path = {p: c[name] for p, c in paths.items()}
        rows.append({
            "name": name, "route": "cuda",
            "source": "lighthand_tpu_torch/csrc/int8_conv.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err, **fig})
    rows[-2]["forward_ms_by_model"] = breakdown
    rows[-2]["stems"] = stem_figs
    rows.append(raster_row)
    print(f"[figures] {card}: rasterize at {raster_row['shape']}: eager "
          f"{raster_row['ms']:.4f} ms, device {raster_row['device_ms']:.4f} "
          f"ms, plain twin {raster_row['plain_ms']:.2f} ms, bound "
          f"{raster_row['bound_ms'] * 1e3:.2f} us by {raster_row['bound_by']}"
          f"; launches on the render path {render_launches}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
