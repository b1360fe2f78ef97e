#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (``lighthand_tpu_torch``) on one NVIDIA GPU:
is it right on the card?

    python3 chip_smoke.py        # from the repository root; needs one card

Each kernel's time alone, against its bound, is ``kernel_breakdown.py``'s;
the end-to-end figures are the benchmark's (``benchmark/``). The inputs and
stored results come from ``tests/torch_fixtures.py``. Phases (any failure
raises, exits nonzero and prints no ok line):

1. device and build: the card's name and power limit (nvidia-smi), then
   the CUDA libraries (one a ``lighthand_tpu_torch/csrc/*.cu``) built with
   nvcc and the host libraries of the data readers (the image codec, the
   TSV engine) with the host C++ compiler, all at once;
1b. the codec: every committed fixture image (``tests/fixtures/images``)
   decoded, gray-decoded, resized to 256 and warped to 224 by the port's
   codec, each equal to the SHA-256 of cv2's result stored beside it (this
   machine has no cv2 for the port to lean on);
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
   pixels); then the bench's shapes (phase 11): B=256 at 256x256 (64x64
   maps) and B=32 and B=256 at 224x224 (56x56 maps);
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
   reached; each model's heaviest shape and its stem again at batch 128
   (the bench's int8_fwd step and the serving bench, phase 11); the twin
   runs on the card with cuDNN off (im2col + DGEMM, exact on integers);
   then the grouped weight quantize (``quantize_weights_cuda``, one launch
   for a list of weights) against ``quantize_weights_plain``, bit for bit,
   over all 292 HRNet-W32 and all 53 ResNet-50 weights in one group each,
   in both layouts, and ragged groups (the K = 27 and 147 stems, Cout 40
   and 33, rows of 45 and 20 values, all-zero channels, a source off
   16-byte alignment, every other output or input channel of a weight,
   rows beyond a stage buffer, a group of one), each w_q at a 128-byte
   offset;
2c. a ``QuantConv2d`` on the card equals the same module on the CPU, bit
   for bit, at ResNet-50's and HRNet-W32's heaviest shapes, bf16 and f32:
   the weight scale divides on both devices;
2d. the BatchNorm kernels (``csrc/batch_norm.cu``) against their twins at
   every distinct BatchNorm shape of HRNet-W32 at bs128 and ResNet-50 at
   bs32 (read by hooks), bf16 and f32, ReLU on and off, training forward
   (output, batch and running statistics, the batch count), its backward,
   eval forward and its backward, and ragged cases (C = 4, 12, 100; 3 rows
   a channel; NCHW input; x off 16-byte alignment); outputs and dx within
   1 ulp of the twin's value in their type + 2^-16 of the largest value,
   statistics, dw and db within 2^-16 (``BN_FLOOR``: the sums add in
   another order); the fused ReLU's gate bit for bit. The end of a
   residual block (``residual=``: ``relu(bn(x) + r)`` in the apply stage's
   one pass) at every residual shape of the five cells (HRNet-W32 bs128,
   ResNet-50 bs32, HRNet-W48 bs32), bf16 and f32, training and eval:
   output, dx, dw, db and dr ``torch.equal`` to the chain the blocks ran
   before (the kernels with ``relu=False``, PyTorch's add and ``relu``,
   autograd's backward of them). Then a graphed W32 bs128 microbatch
   launches each stage once a BatchNorm (3 x 292 each way), an eval batch
   292 eval passes, ``F.batch_norm`` and ``var_mean`` are never called, and
   the benchmark's "batch norm" family holds only ``lh_bn_`` kernels.
   From phase 4 on the three BatchNorm wrappers are counted on every path
   like K1 (``bn_launches``: 3 x the model's BatchNorms a training
   forward and a backward, 1 x an eval forward);
4. the main path, train: HRNet-W32 at 256x256, batch 32, bf16 policy,
   ``make_fused_train_step`` for 3 steps (graphed: the first eager, the
   second captured and replayed, the third replayed); K1 must launch 3
   times and every loss be finite;
5. the main path, eval: ``make_eval_step`` twice on a batch of 32 whose last
   4 rows are padding (n_valid must be 28, K2 must launch), then
   ``make_predict_step`` once; over phases 4 and 5 the BatchNorm wrappers
   launch 3 x 3 x 292 times in training forwards and as many in
   backwards, and 3 x 292 in eval forwards;
4b. int8 training: HRNet-W32, ``DTypePolicy.int8_fwd()``, 3 fused steps:
   finite losses, K1 3 launches, the int8 conv 3 x 292, the grouped
   weight quantize 3 (one a forward) and the BatchNorms of 3 training
   forwards and backwards;
5b. int8 serving: phase 4's W32 weights predicted under bf16 and under
   int8_fwd (``load_state_dict``), the share of joints within 1 heatmap px
   of each other printed; 292 int8 conv launches, 1 weight quantize and
   the BatchNorms of 2 eval forwards;
4c. the flip / rotation route: HRNet-W32, 256x256, bs32, bf16,
   ``make_fused_train_step(flip=True, rot_deg=15.0)`` for 3 steps: finite
   losses, K1 0 and K2 3 launches; the chain (jitter, noise, rotate,
   normalize, flip) on the card against the same chain on the CPU with the
   same draws (the CPU tests' tolerances: images 3e-4, joints 1e-4 px, K2's
   targets 1e-5); the chain without flip or rotation on K1's draws against
   K1 under phase 3's tolerances;
4d. the steps as CUDA graphs (``train/graph.py``; every step of phases
   4-11 runs graphed, its first call of a shape eager, its second captured
   and replayed, the later ones replayed, the launch counters adding each
   replay's captured launches): HRNet-W32 bf16, HRNet-W32 int8_fwd and
   SimpleBaseline ResNet-50 bf16, bs32, 256x256, K=4, 3 dispatches of the
   graphed step, of its eager form and of the eager form again, from the
   same weights, seed and batches, the generator reseeded before the
   third: K1's images and targets bit-equal in all 12 microbatches, each
   microbatch's loss and the final state dict no further from eager than
   the eager rerun (both printed), the launch counts equal, the
   BatchNorms of 12 training forwards and backwards, one graph for the
   step; then the eval step (a batch whose last 4 rows are padding,
   n_valid 28) and the predict step graphed against eager on the trained
   state, 3 batches each, bit for bit, with the BatchNorms of their 12
   eval forwards;
6. the training entry point: ``lighthand_tpu_torch.cli.train.main`` in a
   temporary directory, SimpleBaseline ResNet-50 at 256x256, batch 32, bf16,
   synthetic data (128 train samples, 32 val), 3 microbatches a dispatch:
   run A trains 2 epochs from scratch (``--reset``), run B resumes with 3
   epochs at the best epoch + 1. Each epoch is one K=3 dispatch, a ragged
   K=1 tail step and one eval batch, so K1 must launch 4 times and K2 once
   for every epoch run, and the BatchNorm wrappers 4 x 3 x 56 times in
   training forwards and as many in backwards. Both runs must print the
   ``done:`` line, write finite Loss/train and Loss/valid for every epoch
   run, the checkpoint and ``last_checkpoint.json`` with the model's name
   and precision, and run B must start at run A's best epoch + 1;
6b. the real-data path: the same CLI on a LightHand99K tree written into
   a temporary directory (128 train, 32 eval records pointing at the
   fixture JPEGs), without ``--synthetic``, 2 epochs: the done line,
   finite losses for both epochs, K1 4 and K2 1 launches an epoch, the
   decoded-crop cache's hit fraction 1.0 in epoch 2 (read from the log),
   and the cached rows epoch 2 read equal to a fresh decode;
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
   quantize a batch (106 and 2) and none otherwise, and in each run the
   BatchNorms of one eval forward a batch (2 x 56);
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
   process, both eager (a mesh keeps its step eager; the plain step runs
   its ``.eager`` form): the mesh step within 10 % of the plain one, with
   Adam alone (``train/state.py:ShardAdam``) and the profiler's top
   operations and ranges of both steps. Meshes above one process are
   rehearsed only on the CPU (``tests/test_torch_dist.py``);
9a. ``python -m lighthand_tpu_torch.cli.make_synth_data`` with
   ``SYNTH_ARGS`` (64 train, 32 eval, 32 Armo, 16 FreiHAND TSV): every
   file's SHA-256 equal to the digests of the JAX CLI's tree
   (``tests/fixtures/make_synth_digests.json``, which a CPU test checks;
   this machine's cv2 may differ and is not used);
9b. a 224x224 RGB JPEG encoded at quality 95 decodes to its shape;
9c. ``cli.train`` (SimpleBaseline ResNet-50, bs32, bf16, 1 epoch) on 9a's
   LightHand tree with overlays on: the train overlays at iterations 0 and
   1 and the val overlay at 0, each decoding to 256x512x3 and logged once;
   K1 2 and K2 1 launches;
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
9i. the captions on the host: ``utils/vis3d.py:draw_text`` and
   ``utils/visualize.py:put_text`` (cv2 5.0's FontFace text: Rubik read by
   ``utils/font.py``, rasterized and blended by ``csrc/text.cpp``) on
   ``text_drawings``' seeded cases, every caption equal to the stored
   digests of the JAX package's and cv2 5.0.0's
   (``tests/fixtures/text_digests.json``);
9h. the mesh renderer: the rasterizer kernel (``csrc/rasterize.cu``)
   against its plain twin on the card, bit for bit, at 800x600 and
   224x224 on a MANO-sized procedural mesh with coplanar duplicate faces,
   and on ``raster_edge_cases`` at both of the wrapper's geometries (a tile
   meeting more faces than its list holds, a face larger than a tile,
   faces off the image, 1x1 and 17x13 images); ``Renderer.render`` and
   ``render_vertex_color`` end to end on the card (one rasterizer launch
   each) against the CPU; at most 2 kernels a call and no allocation a
   pixel but the image;
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
   1e-5 relative;
10b. single-sample targets: ``generate_target`` on CUDA joints at J=21,
   H=64, stride 4, and at H=50, stride 3.0 with [J, 3] joints and one
   joint off the map: one K2 launch a call, maps within 1e-5 of the plain
   twin on the card and of the CPU, weights equal to the CPU's;
10c. the jittering preprocessor: ``DevicePreprocessor(jitter=True)`` on a
   u8 bs32 256x256 batch on the card and on the CPU with the same
   injected draws (every op order), f32 out, within 3e-4 in normalised
   units (the chain's bound, phase 4c); no kernel launched;
11. the measurement entry points (``bench_torch.py``, ``tools/
   *_torch.py``) run and count their launches: 11a ``bench_torch.measure``
   on the headline (HRNet-W32, 256x256, bs128, bf16, 4 microbatches a
   dispatch) with 2 measured dispatches: finite positive img/s, finite
   loss, K1 launched (warm-ups + measured + blocked) x 4 times; 11b every
   ``EXTRA_CONFIGS`` entry at one warm-up, one measured and one blocked
   dispatch, each with its launches (int8_fwd: 292 int8 convs and one
   weight quantize a forward); 11c the serving bench (bf16 and int8_fwd
   predict, bs128) at 2 warm-up calls (eager, then the capture), 1
   measured and 1 blocked call, with the int8 kernels' launches; 11d
   ``profile_step_torch`` over 2 profiled dispatches of the headline: K1
   in the kernel ranking (its count, 8 if no event is dropped, printed,
   not checked); 11e ``prewarm_cache_torch`` in a subprocess over a tree
   like phase 6b's: the caches full afterwards and CUDA never initialised
   in the subprocess;
7. reference: the trained W32 in f32 on the card against the same
   weights on the CPU at 64x64, atol 2e-4 / rtol 1e-3 (the tolerances the
   CPU tests hold the port's CPU forward to against JAX), with both TF32
   switches set True beforehand and only the f32 policy's
   ``core/dtypes.py:numerics`` around the forward: it fails if that
   context does not make the convs full f32;
8c. the eval forward of ResNet-50 and HRNet-W32 at bs32 under bf16 and
   int8_fwd: the profiler's count of device kernels a forward must not be
   larger under int8_fwd than under bf16.
   The last line is the ok line.

TF32: phases 1 to 11 run with torch's defaults (``cudnn.allow_tf32`` True,
``cuda.matmul.allow_tf32`` False), as a user's process does: the entry
points' f32 runs set their own full f32 (``core/dtypes.py:numerics``), and
no other phase compares an f32 convolution; the main path's convolutions
are bf16, which TF32 does not touch. Phase 7 sets both True and relies on
the policy's context; phase 8c runs with both False.
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

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.join(REPO, "tests"))

from torch_fixtures import (  # noqa: E402
    ACT_CLIP,
    B_KERNEL,
    B_TRAIN,
    BN_MODELS,
    DIGESTS,
    GEOMETRY_ATOL,
    GEOMETRY_RTOL,
    HM,
    JOINTS,
    OVERLAY_DIGESTS,
    POSE_CATEGORIES,
    PROCRUSTES_ATOL,
    RENDER_SIZES,
    SIZE,
    SYNTH_ARGS,
    TEXT_DIGESTS,
    bn_inputs,
    bn_shapes,
    heaviest_shape,
    int8_inputs,
    int8_twin,
    k1_inputs,
    load_manifest,
    model_quant_weights,
    overlay_digests,
    overlay_drawings,
    procedural_hand_mesh,
    quant_conv_shapes,
    raster_edge_cases,
    text_drawings,
    tree_digests,
    write_armhand_tree,
    write_armo_tree,
    write_freihand_tree,
    write_gan_tree,
    write_lighthand_tree,
)

F32_ATOL = 1e-5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def bf16_ulp(x):
    import torch

    a = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


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


def bn_launches(n_bn: int, train: int = 0, evals: int = 0) -> dict:
    """The BatchNorm wrappers' launches for ``train`` training forwards,
    each with its backward, and ``evals`` eval forwards of a model of
    ``n_bn`` BatchNorms: three a BatchNorm in a training forward and in a
    backward, one in an eval forward."""
    return {"batch_norm_train": 3 * n_bn * train,
            "batch_norm_eval": n_bn * evals,
            "batch_norm_backward": 3 * n_bn * train}


def off(counts: dict, want: dict) -> bool:
    """Whether a count that ``want`` names differs from it (a phase leaves
    out the counts it cannot name)."""
    return any(counts[name] != n for name, n in want.items())


def run_cli(argv: list, counters, tag: str, entry: str = "train") -> tuple:
    """One call of the training (or eval) CLI's ``main``, every kernel's
    count zeroed just before it and read just after; its output is printed
    with ``tag``. Returns (exit code, output, launches)."""
    import importlib

    cli = importlib.import_module(f"lighthand_tpu_torch.cli.{entry}")
    zero(counters)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    counts = read(counters)
    text = out.getvalue()
    print("\n".join(f"[{tag}] {line}" for line in text.splitlines()))
    return rc, text, counts


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


def cli_phase(counters) -> None:
    """Phase 6: two runs of the training CLI."""
    argv = ["--root", "simplebaseline/ours", "--name", "smoke", "--synthetic",
            "--batch_size", str(B_TRAIN), "--num_our", "128",
            "--steps-per-dispatch", "3", "--count", "5", "--yes"]
    run_dir = os.path.join("output", "simplebaseline", "ours", "smoke")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        os.chdir(tmp)
        try:
            seen, best = 0, None
            for tag, extra, epochs in (("A", ["--reset"], 2), ("B", [], 3)):
                rc, text, counts = run_cli(
                    argv + extra + ["--epoch", str(epochs)], counters,
                    f"cli {tag}")
                rows = _scalars(run_dir)[seen:]
                seen += len(rows)
                first = 0 if best is None else best + 1
                ran = list(range(first, epochs))
                train, valid = (_by_epoch(rows, "Loss/train"),
                                _by_epoch(rows, "Loss/valid"))
                print(f"[cli {tag}] epochs {ran}; launches {counts}")
                check_run(f"CLI run {tag}", rc, text, train, valid, ran)
                if f"Start_epoch: {first}" not in text:
                    fail(f"CLI run {tag} did not start at epoch {first}")
                want = {"fused_aug_targets": 4 * len(ran),
                        "heatmap_targets": len(ran), "int8_conv": 0,
                        "quantize_weight": 0}
                # a training forward and its backward per optimizer step;
                # the eval and overlay forwards are not counted out here
                bn = bn_launches(N_BN["resnet50"], 4 * len(ran))
                del bn["batch_norm_eval"]
                if off(counts, {**want, **bn}):
                    fail(f"CLI run {tag}: launches {counts}, expected {want}"
                         f" and {bn} (K1 and a BatchNorm training forward "
                         "and backward once per optimizer step, K2 once per "
                         "eval batch)")
                with open(os.path.join(run_dir, "last_checkpoint.json")) as f:
                    marker = json.load(f)
                if (marker.get("model") != {"name": "simplebaseline",
                                            "precision": "bf16"}
                        or not os.path.isfile(os.path.join(
                            run_dir, "checkpoint-good", "state.pt"))):
                    fail(f"CLI run {tag}: bad checkpoint marker {marker}")
                best = marker["epoch"]
        finally:
            os.chdir(cwd)


def codec_phase() -> None:
    """Phase 1b: every fixture through the port's codec (decode, gray
    decode, resize to 256, warp to 224) against the SHA-256 of cv2's result
    stored beside it; all must be equal."""
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
    print(f"[codec] {checked} results of {len(load_manifest())} fixtures "
          "equal cv2's (bit-exact)")


def real_tree_phase(counters, tmp: str) -> None:
    """Phase 6b: the training CLI on a LightHand99K tree of the fixture
    JPEGs (128 train, 32 eval records), without --synthetic, 2 epochs.
    Checks the done line, finite losses for both epochs, K1 4 and K2 1
    launches an epoch, the decoded-crop cache's hit fraction 1.0 in epoch 2
    (train and eval) and that the cached rows epoch 2 read equal a fresh
    decode of the tree."""
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
        rc, text, counts = run_cli(argv, counters, "real")
        rows = _scalars(run_dir)
        with open(os.path.join(run_dir, "log.txt")) as f:
            log = f.read()
        cfg = parse_args(argv)
        cfg.output_dir = os.path.join(tmp, run_dir)
    finally:
        os.chdir(cwd)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    print(f"[real] launches {counts}")
    check_run("real-tree CLI", rc, text, train, valid, [0, 1])
    # K1 once per optimizer step, K2 once per eval batch, for 2 epochs
    want = {"fused_aug_targets": 2 * (128 // B_TRAIN),
            "heatmap_targets": 2 * math.ceil(32 / B_TRAIN), "int8_conv": 0,
            "quantize_weight": 0}
    if off(counts, want):
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
    print("[real] the 160 cached rows epoch 2 read equal a fresh decode")


def frei_and_mix_phase(state, counters, tmp: str) -> None:
    """Phase 6c: a FreiHAND TSV tree of the fixture JPEG bytes read through
    the Loader (TSV engine bulk reads, base64, decode, the inverse-map
    warp; every row noise-enabled) into one fused step; then one
    ``per_sample`` fused step on a GAN + LightHand mix (max-combine targets
    where ``hm_max`` is set)."""
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
    if off(counts, {"fused_aug_targets": 2, "heatmap_targets": 0,
                    "int8_conv": 0, "quantize_weight": 0}):
        fail(f"frei+mix launches {counts}, expected K1 twice")


# --------------------------------------------------------------- int8 conv


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


def int8_check_phase(shapes: dict) -> None:
    """Phase 2b: both int8 kernels against their twins, bit for bit (0
    differing values): the weight kernel's w_q, s_w and scale, then the
    conv (from the kernel's w_q and scale) on bf16 and f32 activations, in
    bf16 and f32 output; every distinct quantized conv shape of ResNet-50
    and HRNet-W32 at batch 32, and the ragged cases of ``INT8_RAGGED``.
    Every model stem (Cin not a multiple of 32) must take the stem path,
    each ragged case its path, and the simple path must be reached."""
    import torch

    from lighthand_tpu_torch.ops.kernels.int8_conv import (
        conv_plan,
        int8_conv2d_cuda,
        quantize_weight_cuda,
        quantize_weight_plain,
    )

    distinct = sorted({key for model in shapes.values() for key in model})
    bench = [key for uses in shapes.values()
             for key in (heaviest_shape(uses), next(k for k in uses
                                                     if k[0] % 32))]
    cases = ([(B_TRAIN, key, None, False,
               "stem" if key[0] % 32 else "wgmma") for key in distinct]
             + INT8_RAGGED
             + [(B_KERNEL, key, None, False,
                 "stem" if key[0] % 32 else "wgmma") for key in bench])
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
          f"on the stem path), {len(INT8_RAGGED)} ragged ones, and at batch "
          f"{B_KERNEL} {bench}; conv paths (cases x dtypes) {paths}; max |kernel -"
          f" twin| weights {err_w}, conv {err_c}")


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


def grouped_check_phase() -> None:
    """Phase 2b, the grouped weight kernel: ``quantize_weights_cuda``
    against ``quantize_weights_plain`` on the card, bit for bit (0
    differing values of w_q, s_w and scale), over all 292 HRNet-W32 and 53
    ResNet-50 weights in one group each, channels_last and contiguous, and
    the ragged groups; every w_q ``[Cout, kh, kw, Cin]`` contiguous at a
    128-byte offset of its pool."""
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
        n = sum(w.numel() for w in ws)
        print(f"[quantize_weights] {label}: {len(ws)} weights, {n} values: "
              f"{bad} differing values against the twin")
        if bad:
            fail(f"the grouped weight kernel differs from its twin "
                 f"({label}): {bad} values")


def int8_train_phase(batch, counters, n_quant: int) -> None:
    """Phase 4b: HRNet-W32 256x256 bs32 under DTypePolicy.int8_fwd(), 3
    fused train steps. Every loss finite; K1 3 launches, the int8 conv 3 x
    the model's quantized convs, the grouped weight quantize 3 (one a
    forward)."""
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
    losses = []
    for _ in range(3):
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))
    counts = read(counters)
    print(f"[int8 train] HRNet-W32 {SIZE}x{SIZE} bs{B_TRAIN} int8_fwd: "
          f"losses {losses}; launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite int8 train loss: {losses}")
    want = {"fused_aug_targets": 3, "heatmap_targets": 0,
            "int8_conv": 3 * n_quant, "quantize_weight": 3,
            **bn_launches(N_BN["hrnet_w32"], train=3)}
    if counts != want:
        fail(f"int8 train launches {counts}, expected {want}")


def int8_serving_phase(state, images, counters, n_quant: int) -> None:
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
                  "int8_conv": n_quant, "quantize_weight": 1,
                  **bn_launches(N_BN["hrnet_w32"], evals=2)}:
        fail(f"int8 serving launches {counts}, expected {n_quant} int8 "
             "convs, 1 weight quantize and two eval forwards' BatchNorms")


def _pck_rows(path: str) -> list:
    with open(path) as f:
        return [line.rstrip(";").split(";") for line in f.read().splitlines()]


def eval_cli_phase(counters, tmp: str, n_quant: int) -> None:
    """Phase 6d: ``lighthand_tpu_torch.cli.eval.main`` on phase 6b's run
    tree (SimpleBaseline ResNet-50, bf16) over an Armo tree of the fixture
    JPEGs (64 records, 16 per category, some joints hidden, plus 2 short
    records that are dropped), three times: with the checkpoint's precision,
    with ``--precision int8_fwd`` and with ``--test``. Checks exit code 0,
    evaluation.json's categories and counts, the three pck_eval files (5
    rows of finite AUC and EPE and 100 PCK values), the --test AUC lines,
    and under int8_fwd 53 int8 conv launches and 1 weight quantize a batch,
    none otherwise."""
    import numpy as np

    armo = os.path.join(tmp, "armo")
    n_rec = 64
    write_armo_tree(armo, n_rec)
    argv = ["--root", "simplebaseline/ours", "--name", "real", "--eval",
            "--dataset-root", armo, "--batch_size", str(B_TRAIN)]
    batches = math.ceil(n_rec / B_TRAIN)
    run_dir = os.path.join(tmp, "output", "simplebaseline", "ours", "real")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for tag, extra in (("bf16", []), ("int8_fwd", ["--precision",
                                                       "int8_fwd"]),
                           ("test", ["--test"])):
            for f in os.listdir(tmp):
                if f.startswith("pck_eval_"):
                    os.remove(f)
            rc, text, counts = run_cli(argv + extra, counters, f"eval {tag}",
                                       entry="eval")
            print(f"[eval {tag}] {n_rec} images, bs{B_TRAIN}; launches "
                  f"{counts}")
            if rc != 0:
                fail(f"eval CLI ({tag}) exited {rc}")
            int8 = tag == "int8_fwd"
            want = {"fused_aug_targets": 0, "heatmap_targets": 0,
                    "int8_conv": n_quant * batches if int8 else 0,
                    "quantize_weight": batches if int8 else 0,
                    **bn_launches(N_BN["resnet50"], evals=batches)}
            if counts != want:
                fail(f"eval CLI ({tag}): launches {counts}, expected {want}")
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


# the configurations of phase 4d: (model, policy name), K=4, bs32, 256x256
GRAPH_CONFIGS = (("hrnet_w32", "bf16"), ("hrnet_w32", "int8_fwd"),
                 ("resnet50", "bf16"))
GRAPH_K, GRAPH_DISPATCHES = 4, 3


def graph_batch(seed: int, k: int = GRAPH_K, b: int = B_TRAIN) -> dict:
    """A fused step's [K, B, ...] batch on the card, from ``seed``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lead = (k, b)
    batch = {
        "image_u8": rng.integers(0, 256, size=lead + (SIZE, SIZE, 3),
                                 dtype=np.uint8),
        "joints": rng.uniform(16, SIZE - 16, size=lead + (JOINTS, 2))
        .astype(np.float32),
        "aug_enabled": (rng.uniform(size=lead) < 0.5).astype(np.float32),
        "noise_enabled": (rng.uniform(size=lead) < 0.5).astype(np.float32),
    }
    return {k_: torch.from_numpy(v).to("cuda") for k_, v in batch.items()}


def graph_train_run(name: str, policy, graphed: bool, batches, counters):
    """``GRAPH_DISPATCHES`` dispatches of the K=4 fused step, graphed or
    its eager form, from the seed-0 weights and a generator seeded 1 that
    is reseeded to 7 before the last dispatch. Before each Adam step (the
    eager part after a microbatch's replay) it keeps K1's images and
    targets and the microbatch's loss, read from clones that the body
    makes (captured, so each replay refreshes them). Returns (state, the
    kept triples, the launches, every float of the state dict flat)."""
    import torch

    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
    )
    from lighthand_tpu_torch.train import step as step_module

    state = create_train_state(get_model(name, policy=policy),
                               torch.Generator().manual_seed(0), lr=1e-3)
    step = make_fused_train_step(scan_steps=GRAPH_K,
                                 compute_dtype=policy.compute_dtype)
    if not graphed:
        step = step.eager
    gen = torch.Generator(device="cuda").manual_seed(1)
    held, kept = {}, []
    k1, loss_fn = step_module.fused_aug_targets_cuda, step_module.joints_mse_loss
    adam = state.optimizer.step

    def k1_kept(*args, **kwargs):
        images, targets = k1(*args, **kwargs)
        held["k1"] = images.clone(), targets.clone()
        return images, targets

    def loss_kept(pred, target):
        loss = loss_fn(pred, target)
        held["loss"] = loss.detach().clone()
        return loss

    def adam_after_keeping(*args, **kwargs):
        kept.append((held["k1"][0].clone(), held["k1"][1].clone(),
                     held["loss"].clone()))
        return adam(*args, **kwargs)

    step_module.fused_aug_targets_cuda = k1_kept
    step_module.joints_mse_loss = loss_kept
    state.optimizer.step = adam_after_keeping
    try:
        zero(counters)
        for d, batch in enumerate(batches):
            if d == len(batches) - 1:
                gen.manual_seed(7)  # a new epoch's seed between dispatches
            state, _ = step(state, gen, batch)
        torch.cuda.synchronize()
        launches = read(counters)
    finally:
        step_module.fused_aug_targets_cuda = k1
        step_module.joints_mse_loss = loss_fn
        del state.optimizer.step
    flat = torch.cat([v.detach().double().reshape(-1) for v in
                      state.model.state_dict().values()
                      if v.is_floating_point()])
    if graphed and len(step.graphs) != 1:
        fail(f"the K={GRAPH_K} step holds {len(step.graphs)} graphs, not 1")
    return state, kept, launches, flat


def graph_phase(counters) -> None:
    """Phase 4d: the steps as CUDA graphs against their eager forms. For
    HRNet-W32 bf16, HRNet-W32 int8_fwd and SimpleBaseline ResNet-50 bf16,
    bs32, 256x256, K=4: 3 dispatches graphed, the same 3 eager, and the
    eager ones again from the same weights, seed and batches, with a
    reseed before the third: K1's images and targets of every microbatch
    bit for bit; every microbatch's loss and the final state dict
    (parameters and BatchNorm stats) no further from eager than the eager
    rerun is; the launches equal. Then the eval and predict steps, graphed
    against eager on the trained state, 3 batches each, bit for bit, the
    eval batch's last 4 rows padding (n_valid 28)."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.ops.color import normalize_imagenet
    from lighthand_tpu_torch.train import make_eval_step, make_predict_step

    policies = {"bf16": DTypePolicy(), "int8_fwd": DTypePolicy.int8_fwd()}
    batches = [graph_batch(40 + d) for d in range(GRAPH_DISPATCHES)]
    for name, prec in GRAPH_CONFIGS:
        runs = {}
        for mode in ("graphed", "eager", "eager again"):
            runs[mode] = graph_train_run(name, policies[prec],
                                         mode == "graphed", batches,
                                         counters)
            torch.cuda.empty_cache()
        (state, g_kept, g_counts, g_flat), (_, e_kept, e_counts, e_flat), \
            (_, r_kept, _, r_flat) = (runs[m] for m in runs)
        tag = f"{name} {prec} bs{B_TRAIN} K={GRAPH_K}"
        if len(g_kept) != GRAPH_K * GRAPH_DISPATCHES or len(e_kept) != len(
                g_kept):
            fail(f"[graph] {tag}: {len(g_kept)} and {len(e_kept)} "
                 "microbatches kept")
        k1_equal = all(torch.equal(g[0], e[0]) and torch.equal(g[1], e[1])
                       for g, e in zip(g_kept, e_kept))
        loss_gap = [float((g[2] - e[2]).abs()) for g, e in zip(g_kept, e_kept)]
        loss_spread = [float((r[2] - e[2]).abs())
                       for r, e in zip(r_kept, e_kept)]
        state_gap = float((g_flat - e_flat).abs().max())
        state_spread = float((r_flat - e_flat).abs().max())
        print(f"[graph] {tag}: K1 images and targets bit-equal in all "
              f"{len(g_kept)} microbatches: {k1_equal}; loss |graphed - "
              f"eager| {loss_gap}, |eager again - eager| {loss_spread}; "
              f"state dict max |graphed - eager| {state_gap:.6g}, max "
              f"|eager again - eager| {state_spread:.6g}; launches graphed "
              f"{g_counts}, eager {e_counts}")
        if not k1_equal:
            fail(f"[graph] {tag}: K1's images or targets differ from eager")
        if loss_gap[0] != 0.0 or any(g > s for g, s in zip(loss_gap,
                                                             loss_spread)):
            fail(f"[graph] {tag}: a microbatch's loss is further from eager "
                 "than the eager rerun")
        if not state_gap <= state_spread:
            fail(f"[graph] {tag}: the trained state is further from eager "
                 f"({state_gap}) than the eager rerun ({state_spread})")
        if g_counts != e_counts:
            fail(f"[graph] {tag}: launches {g_counts} against eager "
                 f"{e_counts}")
        want = bn_launches(N_BN[name], train=GRAPH_K * GRAPH_DISPATCHES)
        if off(g_counts, want):
            fail(f"[graph] {tag}: launches {g_counts}, expected {want}")
        del runs

        # eval and predict on the trained state, graphed against eager
        valid = torch.ones(B_TRAIN, device="cuda")
        valid[-4:] = 0.0
        eval_step, predict = make_eval_step(), make_predict_step()
        zero(counters)
        for d in range(3):
            batch = graph_batch(50 + d, k=1)
            images = normalize_imagenet(batch["image_u8"][0].float() / 255.0)
            ev = {"image": images, "joints": batch["joints"][0],
                  "valid": valid}
            got, want = eval_step(state, ev), eval_step.eager(state, ev)
            got_p, want_p = predict(state, images), predict.eager(state,
                                                                  images)
            same = (all(torch.equal(got[k], want[k]) for k in want)
                    and all(torch.equal(a, b) for a, b in zip(got_p, want_p)))
            if not same or float(got["n_valid"]) != B_TRAIN - 4:
                fail(f"[graph] {tag}: eval or predict call {d} differs from "
                     f"eager (n_valid {float(got['n_valid'])})")
        counts = read(counters)
        want = bn_launches(N_BN[name], evals=4 * 3)
        if off(counts, want):
            fail(f"[graph] {tag}: eval and predict launches {counts}, "
                 f"expected {want}")
        print(f"[graph] {tag}: eval and predict graphed equal to eager in 3 "
              f"calls each (n_valid {B_TRAIN - 4}); graphs {len(eval_step.graphs)}"
              f" and {len(predict.graphs)}")
        if len(eval_step.graphs) != 1 or len(predict.graphs) != 1:
            fail(f"[graph] {tag}: eval and predict hold "
                 f"{len(eval_step.graphs)} and {len(predict.graphs)} graphs")
        del state, eval_step, predict
        torch.cuda.empty_cache()


def aug_route_phase(counters) -> None:
    """Phase 4c: ``make_fused_train_step(flip=True, rot_deg=15.0)`` on
    HRNet-W32, 256x256, bs32, bf16 for 3 steps (finite losses, K1 0 and K2
    3 launches); the chain on the card against the same chain on the CPU
    with the same draws (f32 images within CHAIN_IMAGE_ATOL, joints within
    CHAIN_JOINT_ATOL, K2's targets from them within F32_ATOL of the plain
    targets); the chain with neither flip nor rotation, on K1's draws,
    against K1 under phase 3's tolerances."""
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
    losses = []
    for _ in range(3):
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))
    counts = read(counters)
    print(f"[aug] HRNet-W32 256x256 bs{B_TRAIN} bf16, flip + rotation 15: "
          f"losses {losses}; launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite losses on the flip/rotation route: {losses}")
    want = {"fused_aug_targets": 0, "heatmap_targets": 3, "int8_conv": 0,
            "quantize_weight": 0}
    if off(counts, want):
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


def _strip_dist_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if not k.startswith("LIGHTHAND_")}


def aug_cli_phase(counters, tmp: str) -> None:
    """Phase 6e: the training CLI with ``--flip --rot-aug 15``
    (SimpleBaseline ResNet-50, synthetic data, 64 train and 32 val
    samples, bs32, 1 epoch): the done line, finite Loss/train and
    Loss/valid, K1 0 and K2 3 launches (2 steps, 1 eval batch) and the
    route's log line once."""
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
        rc, text, counts = run_cli(argv, counters, "cli affine")
        rows = _scalars(os.path.join("output", "simplebaseline", "ours",
                                     "affine"))
    finally:
        os.chdir(cwd)
        route_log.removeHandler(keep)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    routed = [m for m in records if "K1" in m]
    print(f"[cli affine] Loss/train {train}, "
          f"Loss/valid {valid}; launches {counts}; route log lines {routed}")
    check_run("flip/rotation CLI", rc, text, train, valid, [0])
    want = {"fused_aug_targets": 0, "heatmap_targets": 64 // B_TRAIN + 1,
            "int8_conv": 0, "quantize_weight": 0}
    if off(counts, want):
        fail(f"flip/rotation CLI: launches {counts}, expected {want}")
    if len(routed) != 1:
        fail(f"flip/rotation CLI logged its route {len(routed)} times")


DIST_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from lighthand_tpu_torch.cli import train
from lighthand_tpu_torch.ops.kernels import batch_norm as bn
from lighthand_tpu_torch.ops.kernels.fused_aug import fused_aug_targets_cuda
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda
rc = train.main(sys.argv[2:])
print("LAUNCHES " + json.dumps({
    "fused_aug_targets": fused_aug_targets_cuda.launches,
    "heatmap_targets": generate_target_batch_cuda.launches,
    "batch_norm_train": bn.batch_norm_train_cuda.launches,
    "batch_norm_eval": bn.batch_norm_eval_cuda.launches,
    "batch_norm_backward": bn.batch_norm_backward_cuda.launches}))
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
    # the plain step's eager form: a mesh keeps its step eager, and the
    # gate measures the mesh's own cost, not the CUDA graphs'
    states[tag], steps[tag] = state, make_fused_train_step(device=dev,
                                                           mesh=m).eager
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
    step = make_fused_train_step(device=dev, mesh=m).eager
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


def dist_phase(counters, tmp: str) -> None:
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
    (``dist_step_times``), the mesh step within 10 % of the plain one."""
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
        out = subprocess.run(
            [sys.executable, "-c", DIST_CHILD, REPO, *base, "--name", tag,
             *extra], cwd=tmp, env=env, capture_output=True, text=True,
            timeout=300)
        print("\n".join(f"[{tag}] {ln}" for ln in out.stdout.splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:])
            fail(f"the {tag} training subprocess exited {out.returncode}")
        launches = json.loads(out.stdout.split("LAUNCHES ")[-1])
        rows = _scalars(os.path.join(tmp, "output", "simplebaseline", "ours",
                                     tag))
        runs[tag] = (out.stdout, launches, _by_epoch(rows, "Loss/train"),
                     _by_epoch(rows, "Loss/valid"))
        print(f"[{tag}] launches {launches}")
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
    if off(launches, want):
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
        rc, _, _ = run_cli(
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
          f"categories {by_cat}")
    if rc != 0 or by_cat != {c: 8 for c in POSE_CATEGORIES}:
        fail("cli.eval did not read the distributed run's checkpoint")
    print("[dist] meshes above one process (data or model axis > 1) are "
          "rehearsed only on the CPU, in gloo processes "
          "(tests/test_torch_dist.py): this machine has one GPU")


def synth_tree_phase(tmp: str) -> str:
    """Phase 9a: ``python -m lighthand_tpu_torch.cli.make_synth_data`` with
    ``SYNTH_ARGS`` into ``tmp``: every file's SHA-256 equal to the stored
    digests of the JAX CLI's tree (JSON up to the output root). Returns the
    tree's root."""
    out = os.path.join(tmp, "synth")
    proc = subprocess.run(
        [sys.executable, "-m", "lighthand_tpu_torch.cli.make_synth_data",
         "--out", out, *SYNTH_ARGS], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:])
        fail(f"make_synth_data exited {proc.returncode}")
    with open(DIGESTS) as f:
        want = json.load(f)["make_synth_data"]["files"]
    got = tree_digests(out)
    wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    print(f"[synth tree] {len(got)} files, {len(got) - len(wrong)} equal to "
          "the JAX CLI's digests")
    if wrong:
        fail(f"make_synth_data's tree differs from the JAX CLI's in "
             f"{len(wrong)} files, e.g. {wrong[:5]}")
    return out


def encode_phase() -> None:
    """Phase 9b: a 224x224 RGB fixture JPEG encoded at quality 95 decodes
    to its shape."""
    from lighthand_tpu_torch.data import imageio

    img = imageio.imread_rgb(next(e for e in load_manifest()
                                  if e["kind"] == "jpeg")["path"])
    data = imageio.encode_jpeg_rgb(img, 95)
    back = imageio.imdecode_rgb(data)
    print(f"[jpeg] {img.shape} at quality 95: {len(data)} bytes, decoded "
          f"{back.shape}")
    if back.shape != img.shape:
        fail(f"the encoder's JPEG decodes to {back.shape}")


def overlay_cli_phase(counters, tmp: str, synth: str) -> None:
    """Phase 9c: ``cli.train`` (SimpleBaseline ResNet-50, bs32, bf16, 1
    epoch) on 9a's LightHand tree with overlays on (the default): the done
    line, finite losses, K1 2 and K2 1 launches, the train overlays at
    iterations {0, 1} and the val overlay at 0, each decoding to 256x512x3,
    each logged once."""
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
        rc, text, counts = run_cli(argv, counters, "cli overlay")
    finally:
        os.chdir(cwd)
    rows = _scalars(run_dir)
    train, valid = _by_epoch(rows, "Loss/train"), _by_epoch(rows, "Loss/valid")
    check_run("overlay CLI", rc, text, train, valid, [0])
    want = {"fused_aug_targets": 64 // B_TRAIN, "heatmap_targets": 1,
            "int8_conv": 0, "quantize_weight": 0}
    if off(counts, want):
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
    print(f"[cli overlay] overlays {files}; launches {counts}")
    if len(ms) != len(expect):
        fail(f"overlay CLI logged {len(ms)} overlay times")


def plt_eval_phase(counters, tmp: str, synth: str) -> None:
    """Phase 9d: ``cli.eval --plt --plt_max 8`` on 9a's Armo tree (32
    records) with 9c's checkpoint: exactly 8 overlay JPEGs, and
    evaluation.json holding all 32 rows."""
    run_dir = os.path.join(tmp, "output", "simplebaseline", "ours",
                           "overlay")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        rc, _, counts = run_cli(
            ["--root", "simplebaseline/ours", "--name", "overlay", "--eval",
             "--dataset-root", synth, "--batch_size", str(B_TRAIN), "--plt",
             "--plt_max", "8"], counters, "eval plt", entry="eval")
    finally:
        os.chdir(cwd)
    with open(os.path.join(run_dir, "evaluation.json")) as f:
        store = json.load(f)[0]
    n_rows = sum(len(v["gt"]) for v in store.values())
    jpgs = sorted(os.listdir(os.path.join(run_dir, "eval_image", "0_epoch")))
    print(f"[eval plt] rc {rc}; {len(jpgs)} overlays "
          f"{jpgs}; {n_rows} rows in evaluation.json; launches {counts}")
    if rc != 0 or n_rows != 32:
        fail(f"cli.eval --plt: rc {rc}, {n_rows} rows (expected 32)")
    if jpgs != [f"iter_{i}.jpg" for i in sorted(range(8), key=str)]:
        fail(f"cli.eval --plt --plt_max 8 wrote {jpgs}")


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
    ``.png`` route's file decodes (the port's decoder) to the drawn pixels."""
    import numpy as np

    from lighthand_tpu_torch.data import imageio
    from lighthand_tpu_torch.utils import landmarks, vis3d
    from lighthand_tpu_torch.utils import visualize as v

    drawings = overlay_drawings(v.draw_line, v.draw_circle,
                                v.draw_arrowed_line, landmarks, vis3d, tmp)
    with open(OVERLAY_DIGESTS) as f:
        want = json.load(f)["files"]
    got = overlay_digests(drawings)
    wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    print(f"[drawing] {len(got)} drawings and files, {len(got) - len(wrong)} "
          "equal to the digests of the JAX package's cv2 5.0.0 drawings")
    if wrong:
        fail(f"the port's overlays differ from the JAX package's: {wrong}")
    path = os.path.join(tmp, "kp.png")
    img = np.zeros((224, 224, 3), np.uint8)
    kps = np.random.default_rng(5).uniform(0, 224, size=(21, 2))
    canvas = vis3d.vis_keypoints(img, kps, np.ones(21),
                                 vis3d.hand_skeleton_21(), filename=path)
    if not np.array_equal(imageio.imread_rgb(path), canvas):
        fail("the .png route's file does not decode to the drawn pixels")
    print("[drawing] .png route decodes to its pixels")
    print("[drawing] plot_landmarks and vis_3d_keypoints (Matplotlib "
          "figures) are tested on the CPU only (tests/test_torch_landmarks.py"
          ", tests/test_torch_vis3d.py): this machine has no matplotlib")


def _bits_equal(a, b) -> bool:
    """f64 tensors equal bit for bit (NaN where NaN)."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def text_phase() -> None:
    """Phase 9i: the captions on the host that runs the script
    (``utils/vis3d.py:draw_text`` and ``utils/visualize.py:put_text`` over
    ``utils/font.py`` and ``csrc/text.cpp``, built there by g++): every
    drawing of
    ``text_drawings`` equal to the stored digests of what the JAX package
    and cv2 5.0.0 draw, which shows that the host's compiler and CPU give
    cv2's bytes."""
    from lighthand_tpu_torch.utils import vis3d
    from lighthand_tpu_torch.utils import visualize as v

    drawings = text_drawings(vis3d.draw_text, v.put_text)
    with open(TEXT_DIGESTS) as f:
        want = json.load(f)["files"]
    got = overlay_digests(drawings)
    wrong = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    print(f"[text] {len(got)} captions, {len(got) - len(wrong)} equal to the "
          f"digests of the JAX package's and cv2 5.0.0's")
    if wrong:
        fail(f"the port's captions differ from cv2 5.0.0's: {wrong}")


def kernels_a_call(fn, name: str = "", calls: int = 5) -> float:
    """The profiler's count of device kernels (those whose names hold
    ``name``) a call of ``fn``, over ``calls`` calls after one more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0 and name in e.key) / calls


def render_phase() -> None:
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
    the CPU. Then, at each size, the kernel's device kernels a call (at
    most 2) and the bytes a call asks for (nothing a pixel but the
    image)."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.ops.kernels.rasterize import (
        FACE_BYTES,
        GROUP_BYTES,
        LARGE,
        SMALL,
        _face_setup,
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
        inputs[w, h] = (px, z, faces, shaded, image, 1.0, far)
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

    for (w, h), args in inputs.items():
        per_call = kernels_a_call(lambda: rasterize_mesh_cuda(*args),
                                  "raster_")
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
        n_f, image = args[2].shape[0], args[4]
        allowed = (image.numel() * 8 + n_f * FACE_BYTES
                   + -(-n_f // 32) * GROUP_BYTES + n_f * 12 + 65536)
        if extra > allowed:
            fail(f"a rasterizer call at {w}x{h} asks for {extra} bytes, "
                 f"more than the image, the face scratch, the faces' copy "
                 f"and 64 KiB ({allowed})")
        print(f"[rasterize] {w}x{h}: {per_call:g} kernels a call, {extra} "
              f"bytes requested a call (at most {allowed})")


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


def forward_launch_phase() -> None:
    """Phase 8c: the eval-mode forward of ResNet-50 and HRNet-W32 at bs32,
    256x256, under bf16 and under int8_fwd (the same random weights): the
    profiler's count of device kernels a forward must not be larger under
    int8_fwd (a quantized conv launches two kernels, the weight quantize
    and the conv; a bf16 conv launches a weight cast and cuDNN's conv)."""
    import torch

    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import init_weights

    x = torch.randn(B_TRAIN, 3, SIZE, SIZE, device="cuda").to(
        torch.bfloat16, memory_format=torch.channels_last)
    for name in ("resnet50", "hrnet_w32"):
        launches = {}
        for tag, policy in (("bf16", DTypePolicy()),
                            ("int8_fwd", DTypePolicy.int8_fwd())):
            model = get_model(name, policy=policy)
            init_weights(model, torch.Generator().manual_seed(0))
            model = model.eval().to("cuda", memory_format=torch.channels_last)
            with torch.no_grad():
                launches[tag] = kernels_a_call(lambda: model(x), calls=3)
            del model
        print(f"[forward] {name} bs{B_TRAIN} {SIZE}x{SIZE} eval: device "
              f"kernels a forward {launches}")
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


def finetune_phase(weights: dict, batch: dict, counters,
                   name: str = "hrnet_w32", dev=None) -> None:
    """Phase 10a: fine-tuning with a frozen stem, then the full metric set.
    Phase 4's trained ``name`` (``weights``) in a state built with
    ``trainable=freeze_mask(model, FREEZE)``; 3 fused steps (K1 3, K2 0):
    every frozen parameter bit-equal to its start with no gradient, every
    trainable one moved, ``param_count`` unchanged; then the predict step,
    and its heatmaps scored on the card and on the CPU: ``get_max_preds``
    (equal), ``soft_argmax_preds`` (within SOFT_ATOL_PX), ``pck_2d``
    (proportion and mm), ``pck_2d_visible``, ``pck_curve`` over the offline
    eval's two grids, ``pck_3d`` on a lifted copy of the joints (all equal),
    ``keypoint_2d_loss`` and ``keypoint_3d_loss`` (within
    SCORE_LOSS_RTOL)."""
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
    losses = []
    for _ in range(3):
        state, out = step(state, gen, batch)
        losses.append(float(out["loss"]))
    counts = read(counters)
    want = {"fused_aug_targets": 3, "heatmap_targets": 0, "int8_conv": 0,
            "quantize_weight": 0}
    if off(counts, want):
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
    n_frozen = sum(start[k].numel() for k in frozen)
    print(f"[finetune] {name} 256x256 bs{B_TRAIN} bf16, {len(frozen)} of "
          f"{len(mask)} parameters frozen ({n_frozen} of {n_params} "
          f"elements): losses {losses}; launches {counts}; frozen "
          "bit-equal with no gradient, every "
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


def single_target_phase(dev=None) -> None:
    """Phase 10b: ``generate_target`` (one sample) on CUDA joints, through
    K2 with B=1: J=21, H=64, stride 4, [J, 2] joints, and H=50, stride 3.0,
    [J, 3] joints with one joint off the map. Each call launches K2 once;
    its maps within F32_ATOL of the plain twin on the card and of the CPU's,
    its weights equal to the CPU's, the off-map joint's 0."""
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


def preprocessor_phase(counters, dev=None) -> None:
    """Phase 10c: ``DevicePreprocessor(jitter=True)`` on a u8 bs32 256x256
    batch on the card and on the CPU with the same injected draws (CPU
    ``draw_jitter``, every op order): f32 outputs within CHAIN_IMAGE_ATOL in
    normalised units (the chain's bound: the same jitter and normalize,
    each image's contrast mean summed in another order); no kernel
    launches; the default bf16 call with its own draws from a generator on
    the card."""
    import numpy as np
    import torch

    from lighthand_tpu_torch.data import DevicePreprocessor
    from lighthand_tpu_torch.ops.color import draw_jitter

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


# ------------------------------------------------------------- batch norm

# ... and with w48.train.b32's HRNet-W48 at bs32, the residual shapes
RESIDUAL_MODELS = BN_MODELS + (("hrnet_w48", 32),)
N_BN = {"hrnet_w32": 292, "resnet50": 56}  # BatchNorms a forward
# The kernels against their twins: |kernel - twin| <= one ulp of the twin's
# value in the output's type + 2^-16 of the tensor's largest value. The
# ulp: the output is rounded once, and the f32 value it rounds differs in
# the last bits (the statistics summed in another order, and
# (x - mean) * (invstd * w) + b where cuDNN computes its own form). The
# floor: where the terms cancel (y or dx near 0) the f32 difference is
# absolute, about 1e-7 of the largest term; 2^-16 leaves room for the
# few-rows channels (3 rows: 1.2e-6 seen). Statistics, running statistics,
# dw and db: within 2^-16 of the largest value.
BN_FLOOR = 2.0 ** -16


def bn_excess(got, want) -> float:
    """max |got - want| over the tolerance (<= 1 passes): one ulp of
    ``want`` in ``got``'s type + ``BN_FLOOR`` of max |want|."""
    import torch

    g, w = got.float(), want.float()
    bits = 8 if got.dtype == torch.bfloat16 else 24
    a = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - (bits - 1))
    tol = ulp + BN_FLOOR * float(w.abs().max())
    return float(((g - w).abs() / tol).max())


def bn_rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def bn_check(n, c, h, w, dtype, relu: bool, seed: int) -> dict:
    """One shape against the twins: the training forward (y, the batch
    statistics, the running statistics and the batch count), its backward,
    the eval forward and its backward. The ReLU's gate, recomputed in the
    backward, is checked bit for bit: the backward with ``relu`` equals the
    backward without it of dy masked by the forward's own output. The
    gradients are held to the twin's on that masked dy (the twin's mask is
    cuDNN's f32 y, whose sign can differ where |y| < 1e-7)."""
    import torch

    from lighthand_tpu_torch.ops.kernels import batch_norm as bn

    x, dy, wt, b, rm, rv = bn_inputs(n, c, h, w, dtype, seed)
    out = {}
    for training in (True, False):
        rm1, rv1, rm2, rv2 = rm.clone(), rv.clone(), rm.clone(), rv.clone()
        nb1 = torch.zeros((), dtype=torch.long, device="cuda")
        nb2 = nb1.clone()
        if training:
            y, s0, s1 = bn.batch_norm_train_cuda(x, wt, b, rm1, rv1, nb1, 0.1,
                                                 1e-5, relu)
            yw, s0w, s1w = bn.batch_norm_train_plain(x, wt, b, rm2, rv2, nb2,
                                                     0.1, 1e-5, relu)
            out["mean"], out["invstd"] = bn_rel(s0, s0w), bn_rel(s1, s1w)
            out["running"] = max(bn_rel(rm1, rm2), bn_rel(rv1, rv2))
            if int(nb1) != 1:
                fail(f"num_batches_tracked {int(nb1)} after one forward")
        else:
            y = bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, relu)
            yw = bn.batch_norm_eval_plain(x, wt, b, rm, rv, 1e-5, relu)
            s0, s1 = rm, rv
        tag = "train" if training else "eval"
        out[f"y_{tag}"] = bn_excess(y, yw)
        masked = torch.where(y > 0, dy, torch.zeros_like(dy)) if relu else dy
        got = bn.batch_norm_backward_cuda(dy, x, wt, b, s0, s1, training,
                                          1e-5, relu)
        if relu:
            plain = bn.batch_norm_backward_cuda(masked, x, wt, b, s0, s1,
                                                training, 1e-5, False)
            out[f"gate_{tag}"] = all(
                p.shape == q.shape and torch.equal(
                    p.contiguous().view(-1).view(torch.uint8),
                    q.contiguous().view(-1).view(torch.uint8))
                for p, q in zip(got, plain))
        want = bn.batch_norm_backward_plain(masked, x, wt, b, rm, rv,
                                            training, 1e-5, False)
        out[f"dx_{tag}"] = bn_excess(got[0], want[0])
        out[f"dwb_{tag}"] = max(bn_rel(got[1], want[1]),
                                bn_rel(got[2], want[2]))
    torch.cuda.synchronize()
    return out


def bn_residual_check(n, c, h, w, dtype, seed: int) -> dict:
    """A residual block's end at one shape, training and eval: the kernels'
    one pass (``residual=``, and the backward given its output) against
    the chain the blocks ran before it: the kernels with ``relu=False``,
    PyTorch's add and ``relu``, autograd's backward of those two (the
    threshold on the output), then the kernels' backward without the
    ReLU. The residual cancels the BN's output at a third of the elements
    (sums tied at 0) and is -0 at a sixth. {check: torch.equal}: output,
    dx, dw, db, dr; in training also the batch and running statistics."""
    import torch

    from lighthand_tpu_torch.ops.kernels import batch_norm as bn

    x, dy, wt, b, rm, rv = bn_inputs(n, c, h, w, dtype, seed)
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(n, c, h, w, generator=g).to(dtype).cuda()
    pick = torch.randint(0, 6, (n, c, h, w), generator=g).cuda()
    out = {}
    for training in (True, False):
        tag = "train" if training else "eval"
        rm1, rv1, rm2, rv2 = rm.clone(), rv.clone(), rm.clone(), rv.clone()
        nb1 = torch.zeros((), dtype=torch.long, device="cuda")
        nb2 = nb1.clone()
        if training:
            y, t0, t1 = bn.batch_norm_train_cuda(x, wt, b, rm2, rv2, nb2, 0.1,
                                                 1e-5, False)
        else:
            y = bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, False)
            t0, t1 = rm, rv
        r = torch.where(pick < 2, -y, noise)
        r = torch.where(pick == 2, torch.full_like(r, -0.0), r)
        r = r.contiguous(memory_format=torch.channels_last)
        if training:
            o, s0, s1 = bn.batch_norm_train_cuda(x, wt, b, rm1, rv1, nb1, 0.1,
                                                 1e-5, False, r)
            out["stats_train"] = all(torch.equal(p, q) for p, q in (
                (s0, t0), (s1, t1), (rm1, rm2), (rv1, rv2), (nb1, nb2)))
        else:
            o = bn.batch_norm_eval_cuda(x, wt, b, rm, rv, 1e-5, False, r)
            s0, s1 = rm, rv
        with torch.enable_grad():
            yg, rg = (t.detach().requires_grad_() for t in (y, r))
            chain = torch.relu(yg + rg)
            dyp, dr = torch.autograd.grad(chain, (yg, rg), dy)
        want = bn.batch_norm_backward_cuda(dyp, x, wt, b, t0, t1, training,
                                           1e-5, False) + (dr,)
        got = bn.batch_norm_backward_cuda(dy, x, wt, b, s0, s1, training,
                                          1e-5, False, out=o)
        out[f"y_{tag}"] = torch.equal(o, chain)
        for name, p, q in zip(("dx", "dw", "db", "dr"), got, want):
            out[f"{name}_{tag}"] = torch.equal(p, q)
    torch.cuda.synchronize()
    return out


def bn_residual_phase() -> None:
    """The residual block's end in phase 2d: ``bn_residual_check`` at every
    residual shape of ``RESIDUAL_MODELS``, bf16 and f32."""
    import torch

    shapes = set()
    for name, batch in RESIDUAL_MODELS:
        ends = {(batch, c, h, w): k for (c, h, w, relu, res), k
                in bn_shapes(name).items() if res}
        print(f"[bn residual] {name}: {sum(ends.values())} block ends at "
              f"{sorted(ends)}")
        shapes |= set(ends)
    for i, (n, c, h, w) in enumerate(sorted(shapes)):
        for dtype in (torch.bfloat16, torch.float32):
            got = bn_residual_check(n, c, h, w, dtype, seed=300 + i)
            if not all(got.values()):
                fail(f"a residual block's end differs from the chain at "
                     f"{(n, c, h, w)} {dtype}: {got}")
    print(f"[bn residual] one pass == the chain (torch.equal: output, dx, "
          f"dw, db, dr, statistics) at {len(shapes)} shapes, bf16 and f32, "
          f"training and eval")


def bn_path_phase() -> None:
    """One graphed HRNet-W32 bs128 training microbatch (the fused step,
    K=1) and one bs128 eval batch: each replay launches each training stage
    once a BatchNorm (3 x 292 forward, 3 x 292 backward launches) and the
    eval pass once a BatchNorm; ``F.batch_norm`` and ``var_mean`` are
    called 0 times from the first call on; in a profiled replay every
    kernel of the "batch norm" family (``benchmark/lhbench/trace.py``'s
    pattern) is an ``lh_bn_`` kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops.kernels import batch_norm as bn
    from lighthand_tpu_torch.train import (
        create_train_state,
        graph,
        make_eval_step,
        make_fused_train_step,
    )

    b = B_KERNEL
    rng = np.random.default_rng(19)
    batch = {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=(b, SIZE, SIZE, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            16, SIZE - 16, size=(b, JOINTS, 2)).astype(np.float32)),
        "aug_enabled": torch.ones(b), "noise_enabled": torch.ones(b)}
    batch = {k: v.cuda() for k, v in batch.items()}
    state = create_train_state(get_model("hrnet_w32"),
                               torch.Generator().manual_seed(0), lr=1e-3)
    step = make_fused_train_step(scan_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    calls = {"batch_norm": 0, "var_mean": 0}
    real = {"batch_norm": F.batch_norm, "var_mean": torch.var_mean}

    def counting(name):
        def fn(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return fn

    F.batch_norm, torch.var_mean = (counting("batch_norm"),
                                    counting("var_mean"))
    try:
        deltas = []
        for _ in range(3):  # eager, capture, replay
            before = graph.counts()
            state, metrics = step(state, gen, batch)
            deltas.append([a - c for a, c in zip(graph.counts(), before)])
        float(metrics["loss"])
        images = torch.randn(b, SIZE, SIZE, 3, device="cuda")
        eval_step = make_eval_step()
        eval_batch = {"image": images, "joints": batch["joints"],
                      "valid": torch.ones(b, device="cuda")}
        for _ in range(3):
            before = graph.counts()
            eval_step(state, eval_batch)
            eval_deltas = [a - c for a, c in zip(graph.counts(), before)]
        torch.cuda.synchronize()
    finally:
        F.batch_norm, torch.var_mean = real["batch_norm"], real["var_mean"]
    names = [f.__name__ for f in graph.COUNTED]
    replay = dict(zip(names, deltas[-1]))
    ev = dict(zip(names, eval_deltas))
    n_bn = N_BN["hrnet_w32"]
    print(f"[bn path] W32 bs{b} graphed microbatch: launches {replay}; eval "
          f"batch {ev}; F.batch_norm / var_mean calls {calls}")
    if (replay["batch_norm_train_cuda"] != 3 * n_bn
            or replay["batch_norm_backward_cuda"] != 3 * n_bn
            or replay["batch_norm_eval_cuda"] != 0
            or ev["batch_norm_eval_cuda"] != n_bn
            or ev["batch_norm_train_cuda"] != 0 or any(calls.values())):
        fail(f"BatchNorm launches {replay}, eval {ev}, library calls {calls}")
    family = re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw|welford")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, gen, batch)
        torch.cuda.synchronize()
    bn_kernels = {e.key: e.count for e in prof.key_averages()
                  if family.search(e.key.lower())}
    foreign = [k for k in bn_kernels if "lh_bn_" not in k]
    print(f"[bn path] 'batch norm' family of a replayed microbatch: "
          f"{sum(bn_kernels.values())} kernels, "
          f"{len(bn_kernels) - len(foreign)} lh_bn_ names; others: {foreign}")
    if foreign or not bn_kernels:
        fail(f"the batch norm family holds other kernels: {foreign}")
    del state, step


def batch_norm_phase() -> None:
    """Phase 2d: the BatchNorm kernels (``csrc/batch_norm.cu``) against
    their twins on the card at every distinct BatchNorm shape of the
    cells' models (HRNet-W32 bs128, ResNet-50 bs32), bf16 and f32, ReLU on
    and off, training and eval (``bn_check``), and ragged cases (C = 4, 12,
    100; NCHW input; a misaligned x: the one-element path); then
    ``bn_residual_phase`` and ``bn_path_phase``."""
    import torch

    worst, n_checks = {}, 0
    shapes = {}
    for name, batch in BN_MODELS:
        uses = bn_shapes(name)
        print(f"[bn] {name}: {sum(uses.values())} BatchNorms, "
              f"{len(uses)} distinct (C, H, W, relu)")
        for c, h, w, _, _ in uses:
            shapes[batch, c, h, w] = None
    cases = list(shapes) + [(8, 4, 9, 7), (4, 12, 10, 10), (4, 100, 8, 8),
                            (3, 256, 1, 1)]
    for i, (n, c, h, w) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            for relu in (False, True):
                got = bn_check(n, c, h, w, dtype, relu, seed=100 + i)
                n_checks += 1
                for key, v in got.items():
                    worst[key] = (max(worst.get(key, 0.0), v)
                                  if not key.startswith("gate")
                                  else worst.get(key, True) and v)
                bad = [k for k, v in got.items()
                       if (v is False) or (not isinstance(v, bool)
                                           and not v <= (1.0 if k[:2] in (
                                               "y_", "dx") else BN_FLOOR))]
                if bad:
                    fail(f"BatchNorm kernels disagree with the twin at "
                         f"{(n, c, h, w)} {dtype} relu={relu}: {got}")
    # ragged layouts: NCHW x, and x 2 (bf16) or 4 (f32) bytes off alignment
    for dtype in (torch.bfloat16, torch.float32):
        x, _, wt, b, rm, rv = bn_inputs(2, 64, 16, 16, dtype, 7)
        nchw = x.contiguous()
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:]
        off = buf.as_strided(x.shape, x.stride())
        off.copy_(x)
        from lighthand_tpu_torch.ops.kernels import batch_norm as bn
        want = bn.batch_norm_eval_plain(x, wt, b, rm, rv, 1e-5, True)
        for tag, t in (("NCHW", nchw), ("misaligned", off)):
            nb = torch.zeros((), dtype=torch.long, device="cuda")
            y, _, _ = bn.batch_norm_train_cuda(t, wt, b, rm.clone(),
                                               rv.clone(), nb, 0.1, 1e-5, True)
            yw, _, _ = bn.batch_norm_train_plain(x.clone(), wt, b, rm.clone(),
                                                 rv.clone(), nb.clone(), 0.1,
                                                 1e-5, True)
            e = max(bn_excess(y, yw),
                    bn_excess(bn.batch_norm_eval_cuda(t, wt, b, rm, rv, 1e-5,
                                                      True), want))
            n_checks += 1
            if not e <= 1.0:
                fail(f"BatchNorm {tag} {dtype}: {e} of the tolerance")
    print(f"[bn] {n_checks} checks against the twins; worst over them "
          f"(y, dx: of the tolerance; statistics, dw, db: relative; gates "
          f"bit for bit): { {k: v for k, v in sorted(worst.items())} }")

    bn_residual_phase()
    bn_path_phase()


# ------------------------------------------------ the measurement entry points


def _tools():
    """The port's measurement tools (``tools/*_torch.py``) as modules."""
    import importlib

    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return (importlib.import_module("int8_serving_bench_torch"),
            importlib.import_module("profile_step_torch"))


def bench_phase(counters, n_quant: int) -> None:
    """Phases 11a-11b: ``bench_torch.measure`` on the headline with 2
    measured dispatches, then every ``EXTRA_CONFIGS`` entry at one warm-up,
    one measured and one blocked dispatch. img/s finite and positive, every
    loss finite, K1 once a microbatch, under int8_fwd the int8 conv once a
    quantized conv and the grouped weight quantize once a forward."""
    import gc

    import torch

    import bench_torch as bt

    def run(name, batch, size, precision, style, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        zero(counters)
        m = bt.measure(name, batch, size, precision, target_style=style, **kw)
        counts = read(counters)
        dispatches = (kw.get("warmup", bt.WARMUP) + kw.get("measure")
                      + kw.get("blocked", bt.BLOCKED))
        forwards = dispatches * bt.SCAN_STEPS
        int8 = precision == "int8_fwd"
        want = {"fused_aug_targets": forwards, "heatmap_targets": 0,
                "int8_conv": forwards * n_quant if int8 else 0,
                "quantize_weight": forwards if int8 else 0}
        tag = f"{name}@{size} bs{batch} {precision} {style}"
        print(f"[bench] {tag}: {m.img_per_sec:.2f} img/s; loss "
              f"{m.loss:.6f}; launches {counts}")
        if not (math.isfinite(m.img_per_sec) and m.img_per_sec > 0
                and math.isfinite(m.loss)):
            fail(f"bench {tag}: img/s {m.img_per_sec}, loss {m.loss}")
        if off(counts, want):
            fail(f"bench {tag}: launches {counts}, expected {want}")

    run("hrnet_w32", bt.BATCH, bt.SIZE, "bf16", "msra", measure=2)
    for cfg in bt.EXTRA_CONFIGS:
        run(*cfg, measure=1, warmup=1, blocked=1)


def serving_phase(counters, n_quant: int) -> None:
    """Phase 11c: the serving bench's predict (HRNet-W32, 256x256, bs128)
    under bf16 and int8_fwd at 2 warm-up calls (the eager one and the
    capture), 1 measured and 1 blocked call:
    finite predictions; under int8_fwd 4 x the quantized convs and 4
    weight-quantize launches, under bf16 none."""
    import torch

    serving, _ = _tools()
    for precision in ("bf16", "int8_fwd"):
        zero(counters)
        m = serving.measure_predict(precision, warmup=2, measure=1,
                                    blocked=1)
        counts = read(counters)
        int8 = precision == "int8_fwd"
        want = {"fused_aug_targets": 0, "heatmap_targets": 0,
                "int8_conv": 4 * n_quant if int8 else 0,
                "quantize_weight": 4 if int8 else 0}
        print(f"[serving] predict hrnet_w32@256 bs128 {precision}: "
              f"{m.img_per_sec:.2f} img/s; launches {counts}")
        if not (bool(torch.isfinite(m.joints).all()) and m.img_per_sec > 0):
            fail(f"serving {precision}: bad predictions or rate")
        if off(counts, want):
            fail(f"serving {precision}: launches {counts}, expected {want}")


def profile_phase(counters) -> None:
    """Phase 11d: ``profile_step_torch`` on the headline, 1 warm-up and 2
    profiled dispatches (the warm-up's first microbatch eager, its second
    captured: the profiled ones replay): K1 in the kernel ranking (its
    count printed: 8 unless the profiler dropped events), the families,
    the busy share, the graph launches and the dropped-event share."""
    _, profile = _tools()
    zero(counters)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        window = profile.run_workload("hrnet_w32", B_KERNEL, SIZE, tmp,
                                      steps=2, warmup=1)
        summary = profile.summarize(tmp, top_k=12)
    counts = read(counters)
    k1 = [(i, r) for i, r in enumerate(summary.get("rows", []))
          if "fused_aug" in r["op"]]
    print(f"[profile] window {window}; launches {counts}")
    if not k1:
        fail("K1 is not in the profiler's kernel ranking")
    rank, row = k1[0]
    print(f"[profile] K1 is #{rank + 1} of {len(summary['rows'])} kernel "
          f"names: {row['count']} kernels over 2 dispatches (8 expected), "
          f"{row['ms']:.4f} ms a dispatch; launch calls answered "
          f"{summary['matched']} of {summary['launches']} ("
          f"{summary['dropped']} dropped), of them "
          f"{summary['graph_launches']} graph launches carrying "
          f"{summary['graph_kernels']} kernel events; kernel sum over events "
          f"{summary['busy']:.4f}")
    if counts["fused_aug_targets"] != 3 * 4:
        fail(f"profile workload launched K1 {counts['fused_aug_targets']} "
             "times, expected 12")


def prewarm_phase() -> None:
    """Phase 11e: ``tools/prewarm_cache_torch.py`` in a subprocess over a
    LightHand tree like phase 6b's (128 train, 32 eval records): exit 0,
    both caches full afterwards (read here), CUDA never initialised in the
    subprocess."""
    from lighthand_tpu_torch.config import parse_args
    from lighthand_tpu_torch.data.cache import cached_sources
    from lighthand_tpu_torch.data.registry import build_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prewarm_") as tmp:
        root = os.path.join(tmp, "datasets")
        write_lighthand_tree(root, 128, 32)
        argv = ["--root", "simplebaseline/ours", "--name", "prewarm",
                "--dataset-root", root, "--num_our", "128"]
        code = ("import runpy, sys, torch\n"
                "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
                "try:\n"
                "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
                "except SystemExit as e:\n"
                "    assert not e.code, e.code\n"
                "print('cuda initialised', torch.cuda.is_initialized())\n")
        out = subprocess.run(
            [sys.executable, "-c", code,
             os.path.join(REPO, "tools", "prewarm_cache_torch.py"), *argv,
             "--batch", "64"], capture_output=True, text=True, timeout=300,
            cwd=tmp)
        print("\n".join(f"[prewarm] {line}"
                        for line in out.stdout.splitlines()))
        if out.returncode != 0:
            fail(f"prewarm_cache_torch failed: {out.stderr[-2000:]}")
        if "cuda initialised False" not in out.stdout:
            fail("prewarm_cache_torch initialised CUDA")
        fractions = [c.hit_fraction() for src in build_dataset(
            parse_args(argv)) for c in cached_sources(src)]
    print(f"[prewarm] hit fractions afterwards {fractions}")
    if fractions != [1.0, 1.0]:
        fail(f"prewarm left the caches at {fractions}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from bench_torch import card_line
    from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops.color import normalize_imagenet
    from lighthand_tpu_torch.ops.heatmap import generate_target_batch
    from lighthand_tpu_torch.ops.kernels import _build
    from lighthand_tpu_torch.ops.kernels import batch_norm as bn_kernels
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
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    logs = _build.build_all()
    print(f"[build] {sorted(logs)}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    missing = [n for n in _build.SOURCES + _build.HOST_SOURCES
               if not _build.library_path(n).exists()]
    if missing:
        fail(f"libraries not built: {missing}")

    # 1b. the host image codec against cv2's stored results ---------------
    codec_phase()

    # 2. K2 against its plain twin -----------------------------------------
    rng = np.random.default_rng(0)
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

    # 3. K1 against its plain twin -----------------------------------------
    mismatches = count_div_mismatches(dev)
    print(f"[K1] normalize's division: {mismatches} of its 3 x "
          "1,065,353,217 numerators differ from IEEE division")
    if mismatches:
        fail("K1's constant division differs from IEEE division")
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
        # the bench's shapes (phase 11): B=256, and 224x224 with 56x56 maps
        (256, 10, SIZE, SIZE, 2, None, HM, 4.0, JOINTS),
        (B_TRAIN, 11, 224, 224, 2, None, 56, 4.0, JOINTS),
        (256, 12, 224, 224, 2, None, 56, 4.0, JOINTS),
    )
    for b, seed, h, w, cols, order, hm, stride, nj in k1_cases:
        images, joints, params = k1_inputs(b, seed, h, w, cols, order, nj)
        kw = {"heatmap_size": hm, "stride": stride}
        got_img, got_hm = fused_aug_targets_cuda(images, joints, params, **kw)
        want_img, want_hm = fused_aug_targets_plain(images, joints, params,
                                                    **kw)
        torch.cuda.synchronize()
        ok, desc = k1_agrees(got_img, want_img, got_hm, want_hm)
        tag = f"B={b} {h}x{w} hm={hm} J={nj} {launch_geometry(h, w)}"
        print(f"[K1] {tag} bf16: {desc}")
        if not ok:
            fail(f"K1 disagrees with its plain twin at {tag}")
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

    # 2b-2d. the int8 kernels; a QuantConv2d card vs CPU; BatchNorm -------
    shapes = {name: quant_conv_shapes(name)
              for name in ("resnet50", "hrnet_w32")}
    n_quant = {name: sum(uses.values()) for name, uses in shapes.items()}
    print(f"[int8] quantized convs: {n_quant}; distinct shapes: "
          f"{ {name: len(uses) for name, uses in shapes.items()} }")
    if n_quant != {"resnet50": 53, "hrnet_w32": 292}:
        fail(f"quantized conv counts {n_quant}, expected 53 and 292")
    int8_check_phase(shapes)
    grouped_check_phase()
    quant_module_phase()
    batch_norm_phase()
    counters = {"fused_aug_targets": fused_aug_targets_cuda,
                "heatmap_targets": generate_target_batch_cuda,
                "int8_conv": int8_conv2d_cuda,
                "quantize_weight": quantize_weights_cuda,
                "batch_norm_train": bn_kernels.batch_norm_train_cuda,
                "batch_norm_eval": bn_kernels.batch_norm_eval_cuda,
                "batch_norm_backward": bn_kernels.batch_norm_backward_cuda}

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
    losses = []
    for _ in range(3):
        state, metrics = step(state, gen, batch)
        losses.append(float(metrics["loss"]))
    print(f"[train] HRNet-W32 256x256 bs{B_TRAIN} bf16: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite train loss: {losses}")

    # 5. main path: eval + predict -----------------------------------------
    images = normalize_imagenet(batch["image_u8"].float() / 255.0)
    valid = torch.ones(B_TRAIN, device=dev)
    valid[-4:] = 0.0
    eval_batch = {"image": images, "joints": batch["joints"], "valid": valid}
    eval_step = make_eval_step()
    for _ in range(2):
        out = eval_step(state, eval_batch)
    joints_px, maxvals = make_predict_step()(state, images)
    torch.cuda.synchronize()
    launches = read(counters)
    scalars = {k: float(v) for k, v in out.items() if v.ndim == 0}
    print(f"[eval] {scalars}")
    print(f"[path] launches {launches}")
    if launches["fused_aug_targets"] != 3:
        fail(f"K1 launched {launches['fused_aug_targets']} times in 3 steps")
    if launches["heatmap_targets"] < 1:
        fail("the eval step did not launch K2")
    if launches["int8_conv"] or launches["quantize_weight"]:
        fail("the bf16 path launched an int8 kernel")
    # 3 training forwards and backwards; 2 eval calls and 1 predict
    want = bn_launches(N_BN["hrnet_w32"], train=3, evals=3)
    if off(launches, want):
        fail(f"BatchNorm launches on the main path {launches}, expected "
             f"{want}")
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
    int8_train_phase(batch, counters, n_quant["hrnet_w32"])
    int8_serving_phase(state, images, counters, n_quant["hrnet_w32"])
    # 4c. the flip / rotation route: the chain and K2 instead of K1
    aug_route_phase(counters)
    # 4d. the steps as CUDA graphs against their eager forms
    graph_phase(counters)
    # 6. the training entry point
    cli_phase(counters)
    # 6b-6d. the real-data path: a LightHand tree through the CLI, then a
    # FreiHAND TSV tree and a GAN + LightHand mix through fused steps, then
    # the eval entry point on 6b's run over an Armo tree
    with tempfile.TemporaryDirectory(prefix="chip_smoke_real_") as tmp:
        real_tree_phase(counters, tmp)
        frei_and_mix_phase(state, counters, tmp)
        eval_cli_phase(counters, tmp, n_quant["resnet50"])
    # 6e-6f. the training CLI with --flip --rot-aug, then under the
    # environment contract at world size 1 (NCCL) against a plain run
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aug_") as tmp:
        aug_cli_phase(counters, tmp)
        dist_phase(counters, tmp)
    # 9a-9f. the tree-making CLIs, JPEG writing, overlays, geometry
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trees_") as tmp:
        synth = synth_tree_phase(tmp)
        encode_phase()
        overlay_cli_phase(counters, tmp, synth)
        plt_eval_phase(counters, tmp, synth)
        make_lighthand_phase(tmp)
    geometry_phase()
    # 9g-9i. the landmark and skeleton overlays; the captions; the mesh
    # renderer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_draw_") as tmp:
        drawing_phase(tmp)
    text_phase()
    render_phase()
    # 10a-10c. fine-tuning with a frozen stem and the metric set; single
    # sample targets through K2; the jittering preprocessor
    finetune_phase(w32_weights, batch, counters)
    del w32_weights
    single_target_phase()
    preprocessor_phase(counters)
    # 11a-11e. the measurement entry points: the bench (headline, then
    # every EXTRA_CONFIGS entry), the serving bench, the step profiler and
    # the cache pre-warmer
    bench_phase(counters, n_quant["hrnet_w32"])
    serving_phase(counters, n_quant["hrnet_w32"])
    profile_phase(counters)
    prewarm_phase()

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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 8c. an int8_fwd forward launches no more device kernels than bf16's
    forward_launch_phase()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
