"""Offline evaluation harness: prediction store + PCK/AUC/EPE curves with
per-occlusion-category breakdown.

Counterpart of ``lighthand_tpu/eval/harness.py`` (reference: pred_store /
pred_eval / pred_store_test / pred_test, src/utils/argparser.py:246-438,
and the wearable_eval_2d CLI, src/tools/wearable_eval_2d.py:23-85), with
the same constants: mm threshold grids use linspace(T0,T1,101)[1:] *
2.83464567 (eval set) / * 3.7795275591 (test), pckb uses
linspace(T0,T1,100); AUC is trapezoid-integrated and normalized by the
threshold range; EPE is reported in mm as px / 3.7795275591.

Inference runs on the device; only the decoded joints come back to the
host. JSON artifacts keep the reference layout: ``dump`` wraps the payload
in a single-element list and ``pred_eval`` reads ``meta[0]`` (dir.py:19-22,
argparser.py:334).

``compat_mean_epe=True`` replicates a reference quirk: the all-category
"mean_auc" EPE concatenates the per-category errors onto a zero-initialized
[971, 21] array (argparser.py:345,367), deflating the reported mean by the
971 zero rows. The paper's numbers come from this code path, so compat is
the default; pass False for the corrected statistic.

Under a device mesh each process predicts its data index's rows of every
batch; ``_gather_rows`` all-gathers them (``parallel.all_gather_metrics``)
so every process holds the whole store, and rank 0 alone writes it
(``lighthand_tpu/eval/harness.py:39-50,65-80``).

Differences from the JAX package: ``_local_rows`` is a copy to host
numpy; the gathered rows keep the single-process order (JAX concatenates
them process by process), so a store from any mesh equals the one-process
store; ``preprocess`` is a function of the u8 images alone (the eval
preprocessor draws nothing). The ``--plt`` overlays are drawn and written
on the host (``utils/visualize.py``) by rank 0, from its own rows, as the
JAX package's host leader does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from lighthand_tpu_torch.core.mesh import is_host_leader
from lighthand_tpu_torch.data.armo import POSE_CATEGORIES
from lighthand_tpu_torch.ops.metrics import (
    MM_THRESH_SCALE_EVAL,
    PX_TO_MM_EVAL,
)


def dump(path: str, payload) -> None:
    """JSON dump wrapped in a list (reference dir.py:13-22), by rank 0."""
    if not is_host_leader():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump([payload], f)


def _local_rows(x) -> np.ndarray:
    """A batch array as host numpy, in row order."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _gather_rows(tree: Dict[str, np.ndarray], mesh=None,
                 per_batch: int = 0) -> Dict[str, np.ndarray]:
    """Every process's rows in the global order; the identity without a
    mesh. Each process holds, batch after batch, its data index's block of
    ``per_batch`` rows of each batch; processes along the model axis hold
    the same blocks, so model index 0's are kept, and each batch's blocks
    are put back in data-index order."""
    if mesh is None:
        return tree
    from lighthand_tpu_torch.parallel import all_gather_metrics

    gathered = all_gather_metrics(tree)
    ranks = mesh.mesh[:, 0].tolist()  # data index 0.., model index 0
    out = {}
    for k in tree:
        blocks = np.stack([gathered[r][k] for r in ranks])
        blocks = blocks.reshape((len(ranks), -1, per_batch)
                                + blocks.shape[2:])
        out[k] = np.swapaxes(blocks, 0, 1).reshape(
            (-1,) + blocks.shape[3:])
    return out


def _images(batch, preprocess):
    images_u8 = batch["image_u8"]
    return images_u8 if preprocess is None else preprocess(images_u8)


def _save_overlays(images, gt, pred, valid, overlay_dir: str,
                   sample_idx: int, overlay_max: int | None) -> int:
    """The overlays of one batch's valid rows; returns the next index."""
    from lighthand_tpu_torch.utils.visualize import save_overlay

    imgs = None
    for i in range(gt.shape[0]):
        if not valid[i]:
            continue
        if overlay_max is None or sample_idx < overlay_max:
            if imgs is None:  # the batch comes to the host once
                imgs = (images.float() if isinstance(images, torch.Tensor)
                        else np.asarray(images, np.float32))
                imgs = _local_rows(imgs)
            save_overlay(imgs[i], gt[i], pred[i], overlay_dir, "eval", 0,
                         sample_idx)
        sample_idx += 1
    return sample_idx


def pred_store(loader, predict_fn, out_path: str, preprocess=None,
               overlay_dir: str | None = None,
               overlay_max: int | None = None, mesh=None) -> Dict:
    """Run inference over the (Armo) eval loader and bucket
    {bbox_diag, pred, gt} per pose category (argparser.py:246-281).

    ``predict_fn(images) -> pred_joints [B,21,2]`` (already x4 to image
    space); ``preprocess(images_u8) -> images``. ``loader`` yields batches
    with joints [B,21,3] and, for the Armo set, the ``pose_ctgy`` list.
    With ``overlay_dir`` (``--plt``) rank 0 writes the GT | prediction
    overlay of each of its valid rows, numbered in order, to
    ``{overlay_dir}/eval_image/0_epoch/iter_{n}.jpg``, the first
    ``overlay_max`` of them (``--plt_max``; all with None); the store
    holds every row whatever the cap."""
    preds, gts, valids, cat_idx = [], [], [], []
    sample_idx = 0
    for batch in loader:
        images = _images(batch, preprocess)
        pred = _local_rows(predict_fn(images))
        gt = _local_rows(batch["joints"])  # [B,21,3] with visibility
        valid = _local_rows(batch.get("valid", np.ones(gt.shape[0])))
        cats = batch.get("pose_ctgy", ["Standard"] * gt.shape[0])
        preds.append(pred)
        gts.append(gt)
        valids.append(valid)
        cat_idx.append(np.asarray([POSE_CATEGORIES.index(c) for c in cats],
                                  np.int32))
        if overlay_dir is not None and is_host_leader():
            sample_idx = _save_overlays(images, gt, pred, valid, overlay_dir,
                                        sample_idx, overlay_max)

    rows = _gather_rows({
        "pred": np.concatenate(preds),
        "gt": np.concatenate(gts),
        "valid": np.concatenate(valids),
        "cat": np.concatenate(cat_idx),
    }, mesh, len(valids[0]))

    meta = {c: {"bb": [], "pred": [], "gt": []} for c in POSE_CATEGORIES}
    for i in range(rows["gt"].shape[0]):
        if not rows["valid"][i]:
            continue  # padding row of the final partial batch
        gt_i = rows["gt"][i]
        w = gt_i[:, 0].max() - gt_i[:, 0].min()
        h = gt_i[:, 1].max() - gt_i[:, 1].min()
        cat = POSE_CATEGORIES[int(rows["cat"][i])]
        meta[cat]["bb"].append(float(np.sqrt(w**2 + h**2)))
        meta[cat]["pred"].append(rows["pred"][i].tolist())
        meta[cat]["gt"].append(gt_i.tolist())

    dump(out_path, meta)
    return meta


def _threshold_grid(t_list: Sequence[float], method: str) -> np.ndarray:
    if method == "mm":
        return np.linspace(t_list[0], t_list[-1], 101)[1:] * MM_THRESH_SCALE_EVAL
    if method == "pckb":
        return np.linspace(t_list[0], t_list[-1], 100)
    raise ValueError(f"method must be mm|pckb, got {method}")


def pred_eval(eval_json_path: str, t_list: Sequence[float], method: str,
              compat_mean_epe: bool = True,
              compat_rows: int = 971) -> Dict[str, list]:
    """Per-category + mean AUC / EPE(mm) / PCK curve (argparser.py:326-388).

    Returns {category: [auc, epe_mm, pck_curve(list)], ..., 'mean_auc': [...]}.
    """
    with open(eval_json_path) as f:
        meta = json.load(f)[0]

    thresholds = _threshold_grid(t_list, method)
    norm_factor = np.trapezoid(np.ones_like(thresholds), thresholds)
    eps = np.finfo(float).tiny

    total_pck = np.empty((0,))
    total_epe = (np.zeros((compat_rows, 21)) if compat_mean_epe
                 else np.zeros((0, 21)))
    out: Dict[str, list] = {}

    for p_type, rec in meta.items():
        if not rec["gt"]:
            # category with no samples (possible with partial eval sets;
            # the real Armo set populates all four)
            continue
        bbox = np.asarray(rec["bb"], dtype=float)
        pred = np.asarray(rec["pred"], dtype=float)
        gt = np.asarray(rec["gt"], dtype=float)

        diff = np.sqrt(((gt[:, :, :2] - pred[:, :, :2]) ** 2).sum(-1))
        if method == "pckb":
            norm_diff = diff / bbox[:, None]
        else:
            norm_diff = diff
        vis = gt[:, :, -1] == 1
        visible_diff = norm_diff[vis]

        total_epe = np.concatenate([total_epe, diff], axis=0)
        total_pck = np.concatenate([visible_diff, total_pck])

        total = len(visible_diff)
        pck_t = np.array(
            [(visible_diff < t).sum() / total * 100 for t in thresholds]
        )
        auc = np.trapezoid(pck_t, thresholds) / (norm_factor + eps)
        out[p_type] = [float(auc), float(diff.mean() / PX_TO_MM_EVAL),
                       pck_t.tolist()]

    total = len(total_pck)
    pck_t = np.array([(total_pck < t).sum() / total * 100 for t in thresholds])
    auc = np.trapezoid(pck_t, thresholds) / (norm_factor + eps)
    out["mean_auc"] = [float(auc), float(total_epe.mean() / PX_TO_MM_EVAL),
                       pck_t.tolist()]
    return out


def pred_store_test(loader, predict_fn, out_path: str,
                    preprocess=None, mesh=None) -> Dict:
    """Flat variant without categories (argparser.py:284-323)."""
    preds, gts, valids = [], [], []
    for batch in loader:
        preds.append(_local_rows(
            predict_fn(_images(batch, preprocess)))[..., :2])
        gt = _local_rows(batch["joints"])[..., :2]
        gts.append(gt)
        valids.append(_local_rows(batch.get("valid",
                                            np.ones(gt.shape[0]))))
    rows = _gather_rows({"pred": np.concatenate(preds),
                         "gt": np.concatenate(gts),
                         "valid": np.concatenate(valids)},
                        mesh, len(valids[0]))
    keep = rows["valid"] > 0
    pred, gt = rows["pred"][keep], rows["gt"][keep]
    bb = [float(np.sqrt((gt[i, :, 0].max() - gt[i, :, 0].min()) ** 2
                        + (gt[i, :, 1].max() - gt[i, :, 1].min()) ** 2))
          for i in range(gt.shape[0])]
    meta = {"pred": [pred.tolist()], "gt": [gt.tolist()], "bb": [bb]}
    dump(out_path, meta)
    return meta


def pred_test(test_json_path: str, t_list: Sequence[float],
              method: str) -> Tuple[float, float]:
    """(auc, mean_epe_px) over the flat store (argparser.py:391-438);
    mm grid here scales by 3.7795275591 (argparser.py:399)."""
    with open(test_json_path) as f:
        meta = json.load(f)[0]

    if method == "mm":
        thresholds = np.linspace(t_list[0], t_list[-1], 101)[1:] * PX_TO_MM_EVAL
    elif method == "pckb":
        thresholds = np.linspace(t_list[0], t_list[-1], 100)
    else:
        raise ValueError(method)
    norm_factor = np.trapezoid(np.ones_like(thresholds), thresholds)

    bbox = np.concatenate([np.asarray(b, dtype=float)
                           for b in meta["bb"]])
    gt = np.concatenate([np.asarray(g, dtype=float) for g in meta["gt"]])
    pred = np.concatenate([np.asarray(p, dtype=float) for p in meta["pred"]])

    diff = np.sqrt(((gt - pred) ** 2).sum(-1))
    norm_diff = diff / bbox[:, None] if method == "pckb" else diff
    norm_diff = norm_diff.flatten()
    total = len(norm_diff)
    pck_t = np.array([(norm_diff < t).sum() / total * 100
                      for t in thresholds])
    auc = np.trapezoid(pck_t, thresholds) / (norm_factor +
                                             np.finfo(float).tiny)
    return float(auc), float(diff.mean())
