"""Offline evaluation CLI: counterpart of ``lighthand_tpu/cli/eval.py``,
the wearable_eval_2d equivalent (src/tools/wearable_eval_2d.py:23-85). It
walks a checkpoint tree, runs pred_store + pred_eval for the threshold
regimes pckb[0.1,0.3], mm[0,30] and mm[0,50], and writes semicolon-CSV
``pck_eval_*.txt`` rows (category;name;auc;epe;pck...), e.g.

    python -m lighthand_tpu_torch.cli.eval --root simplebaseline/ours \
        --name smoke --eval --dataset-root DIR [--precision int8_fwd]

It runs on the card; ``--platform cpu`` runs the same program on the host.
Without a card and without that flag it raises (``core/device.py``: the
port's counterpart of the JAX package's ``device_reachability_gate``).
It reads the port's checkpoints (``checkpoint-*/state.pt``); a JAX
package's orbax checkpoint raises, naming ``tools/orbax_to_torch.py``,
which converts such a run into the port's layout.

In a process group (``core/dist.py``; ``torchrun`` or the
``LIGHTHAND_*`` variables) each process predicts its data index's rows of
every batch with a whole copy of the weights, the rows are gathered, and
rank 0 alone writes the stores and reports the curves
(``lighthand_tpu/cli/eval.py:68-70,85,170-172``).
"""

from __future__ import annotations

import os
import sys

import torch.distributed as dist

from lighthand_tpu_torch.config import parse_args
from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.dist import (
    maybe_initialize_distributed,
    process_device,
    shutdown,
)
from lighthand_tpu_torch.core.mesh import MeshSpec, create_mesh, is_host_leader
from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
from lighthand_tpu_torch.data import Loader, build_dataset, preprocess_u8
from lighthand_tpu_torch.eval.harness import (
    pred_eval,
    pred_store,
    pred_store_test,
    pred_test,
)
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.train.checkpoint import (
    STATE_FILE,
    load_weights_only,
    read_model_info,
)
from lighthand_tpu_torch.train.state import create_train_state
from lighthand_tpu_torch.train.step import make_predict_step
from lighthand_tpu_torch.train.watchdog import StallWatchdog
from lighthand_tpu_torch.utils.logging import colored

THRESHOLD_REGIMES = [
    ("pckb", [0.1, 0.3]),
    ("mm", [0, 30]),
    ("mm", [0, 50]),
]


def serving_policy(precision: str, info) -> DTypePolicy:
    """Pick the per-checkpoint inference policy.

    An explicit ``--precision int8_fwd`` is a serving override (quantized
    forward on any checkpoint; the int8 parameters are bf16's); otherwise
    the checkpoint's recorded training precision wins, falling back to the
    CLI default."""
    if precision == "int8_fwd":
        return DTypePolicy.int8_fwd()
    if info and info.get("name") and info.get("precision") == "f32":
        return DTypePolicy.full_precision()
    if not (info and info.get("name")) and precision == "f32":
        return DTypePolicy.full_precision()
    return DTypePolicy()


def find_checkpoints(model_path: str):
    """Collect checkpoint dirs under a run tree (reference collected *.bin,
    wearable_eval_2d.py:33-37; the port's are ``checkpoint-*/state.pt``)."""
    found = []
    for root, dirs, _ in os.walk(model_path):
        for d in dirs:
            if d.startswith("checkpoint-") and "tmp" not in d:
                found.append(os.path.join(root, d))
    return sorted(found)


def main(argv=None) -> int:
    cfg = parse_args(argv, phase="test")
    cfg.eval.eval = True
    # a process group this call starts, it also ends
    started = not dist.is_initialized() and maybe_initialize_distributed(
        cfg.platform)
    try:
        return _evaluate(cfg)
    finally:
        if started:
            shutdown()


def _evaluate(cfg) -> int:
    device = resolve_device(process_device(cfg.platform) or cfg.platform)
    mesh = create_mesh(MeshSpec(cfg.mesh.data, cfg.mesh.model), device)
    # heartbeat per eval batch; 0 disables
    watchdog = StallWatchdog(cfg.train.stall_timeout_s).start()

    _, eval_src = build_dataset(cfg)

    # The reference walks the hardcoded frei train tree
    # (wearable_eval_2d.py:32: model_path = "output/simplebaseline/frei").
    # Prefer the exact run the user named when it has checkpoints, then the
    # reference's output/<model>/frei walk, then the whole root.
    frei_tree = os.path.join("output", cfg.name.split("/")[0], "frei")
    ckpts = (find_checkpoints(cfg.output_dir)
             or (find_checkpoints(frei_tree)
                 if os.path.isdir(frei_tree) else [])
             or find_checkpoints(cfg.root_path))
    model_path = cfg.output_dir
    if not ckpts:
        print(f"no checkpoints under {model_path}", file=sys.stderr)
        return 1

    size = cfg.data.image_size
    predict_step = make_predict_step(stride=size / cfg.data.heatmap_size,
                                     device=device)

    # Inference once per checkpoint; the prediction store is independent of
    # the threshold regime (the reference re-ran pred_store per regime,
    # wearable_eval_2d.py:45-58).
    stores = []
    for ckpt in ckpts:
        run_name = os.path.relpath(os.path.dirname(ckpt), cfg.root_path)
        if not os.path.isfile(os.path.join(ckpt, STATE_FILE)):
            raise NotImplementedError(
                f"{ckpt} holds no {STATE_FILE}: the port does not read the "
                "JAX package's orbax checkpoints; convert the run with "
                "`python tools/orbax_to_torch.py <run_dir> <out_dir>` where "
                "jax and orbax are installed")
        # architecture identity: the checkpoint's own record wins; the
        # path prefix only covers trees saved without model_info
        info = read_model_info(ckpt)
        if info and info.get("name"):
            model_name = info["name"]
        else:
            model_name = run_name.split("/")[0] \
                if run_name.split("/")[0] in ("simplebaseline", "hrnet") \
                else cfg.model.name
        # --precision int8_fwd is a SERVING override: quantized-forward
        # convs (ops/quant.py) on any checkpoint, which shares the bf16
        # parameters. Otherwise the checkpoint's recorded precision wins.
        policy = serving_policy(cfg.model.precision, info)
        model = get_model(model_name, policy=policy)
        state = load_weights_only(create_train_state(model, device=device),
                                  ckpt)

        def predict(im, _state=state):
            # one read per batch, so the heartbeat attests device work done
            out = predict_step(_state, im)[0].cpu()
            watchdog.heartbeat()
            return out

        watchdog.disarm()

        loader = Loader(eval_src, cfg.data.batch_size, device=device,
                        shuffle=False, num_workers=cfg.data.num_workers,
                        drop_last=False,  # keep all 971 eval samples
                        mesh=mesh)
        # preprocess_u8 normalises to bf16 whatever the policy, as the JAX
        # CLI's DevicePreprocessor(jitter=False) does; an f32 checkpoint
        # predicts in full f32 (core/dtypes.py:numerics)
        with numerics(policy):
            if cfg.eval.test:
                # flat --test flow (reference pred_store_test/pred_test,
                # argparser.py:284-323,391-438): final_model/{name}/test.json
                out_json = os.path.join("final_model", run_name, "test.json")
                pred_store_test(loader, predict, out_json,
                                preprocess=preprocess_u8, mesh=mesh)
            else:
                out_json = os.path.join("output", run_name,
                                        "evaluation.json")
                overlay_dir = (os.path.join("output", run_name)
                               if cfg.eval.plt else None)
                pred_store(loader, predict, out_json,
                           preprocess=preprocess_u8, overlay_dir=overlay_dir,
                           overlay_max=cfg.eval.plt_max, mesh=mesh)
        stores.append((out_json, run_name))

    watchdog.stop()
    if not is_host_leader():
        return 0  # rank 0 wrote the stores and reports the curves

    if cfg.eval.test:
        for t_type, t_list in THRESHOLD_REGIMES:
            for out_json, run_name in stores:
                auc, epe_px = pred_test(out_json, t_list, t_type)
                print(f"{run_name} [{t_type} {t_list[1]}]: "
                      f"auc={auc:.2f} epe={epe_px:.2f}px")
        return 0

    for t_type, t_list in THRESHOLD_REGIMES:
        rows = []
        for out_json, run_name in stores:
            pck = pred_eval(out_json, t_list, t_type,
                            compat_mean_epe=cfg.eval.compat_mean_epe)
            rows.append((pck, run_name))

        file_name = (f"pck_eval_{'_'.join(model_path.split('/')[1:])}"
                     f"_{t_type}_{t_list[1]}.txt")
        with open(file_name, "w") as f:
            for total_pck, name in rows:
                for p_type in total_pck:
                    f.write("{};{};{:.2f};{:.2f};".format(
                        p_type, name, total_pck[p_type][0],
                        total_pck[p_type][1]))
                    for idx, p in enumerate(total_pck[p_type][2]):
                        f.write(f"{p:.2f};")
                        if idx == len(total_pck[p_type][2]) - 1:
                            f.write("\n")
        print(colored(f"Writting ===> {os.path.abspath(file_name)}",
                      "green"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
