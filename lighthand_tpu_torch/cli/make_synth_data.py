"""Deterministic synthetic dataset trees in the reference's on-disk layouts.

Counterpart of ``lighthand_tpu/cli/make_synth_data.py``: for the same
arguments it writes the same tree, byte for byte (every JPEG, TSV,
``.lineidx`` and yaml file; the JSON files name paths under ``--out``).
Images come from ``data/synthetic.py:render_hand`` with the same seeds and
are encoded by the port's JPEG encoder at quality 95 (the bytes cv2
writes), so no OpenCV is needed:

- LightHand layout ({root}/LightHand/annotations/{phase}/
  CISLAB_{phase}_data.json + JPEGs; images at 224 px with joints in 224
  space, scaled x size/224 at load — reference src/tools/dataset.py:132)
- Armo layout ({root}/Armo_hand_dataset/rgb/*.jpg + annotations.json with
  normalized coordinates, per-joint visibility and pose categories —
  reference src/tools/dataset.py:233-300)
- FreiHAND TSV layout ({root}/freihand_synth/: base64-JPEG image, label and
  hw TSV shards, their concatenation and a yaml descriptor —
  frei_dataloader.py:49-107)

Usage:
    python -m lighthand_tpu_torch.cli.make_synth_data --out DIR \
        --n-train 20000 --n-eval 2000 --n-armo 971
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from lighthand_tpu_torch.data.armo import POSE_CATEGORIES
from lighthand_tpu_torch.data.imageio import imwrite_rgb
from lighthand_tpu_torch.data.synthetic import render_hand, synth_hand_joints


def write_lighthand_tree(root: str, phase: str, n: int, seed: int,
                         size: int = 224, log_every: int = 2000) -> str:
    """LightHand-format shard: JPEGs + CISLAB_{phase}_data.json."""
    img_dir = os.path.join(root, "LightHand", "images", phase)
    anno_dir = os.path.join(root, "LightHand", "annotations", phase)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(anno_dir, exist_ok=True)
    meta = []
    t0 = time.time()
    for i in range(n):
        rng = np.random.default_rng(seed * 1_000_003 + i)
        joints = synth_hand_joints(rng, size)
        fname = os.path.join(img_dir, f"{i:07d}.jpg")
        # resume fast path: an image is a pure function of (seed, i), so a
        # file left by an interrupted run is already right; skip the render
        # (the expensive part) and keep only the joints
        if not os.path.exists(fname):
            imwrite_rgb(fname, render_hand(joints, rng, size), 95)
        meta.append({"file_name": fname, "joint_2d": joints.tolist()})
        if log_every and (i + 1) % log_every == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"  {phase}: {i + 1}/{n} ({rate:.0f} img/s)", flush=True)
    anno_path = os.path.join(anno_dir, f"CISLAB_{phase}_data.json")
    with open(anno_path, "w") as f:
        json.dump(meta, f)
    return anno_path


def write_armo_tree(root: str, n: int, seed: int, size: int = 256,
                    log_every: int = 2000) -> str:
    """Armo-format eval set: rgb/*.jpg + annotations.json with normalized
    coordinates, visibility, and a pose category per record."""
    rgb_dir = os.path.join(root, "Armo_hand_dataset", "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    records = {}
    t0 = time.time()
    for i in range(n):
        rng = np.random.default_rng(seed * 2_000_003 + i)
        joints = synth_hand_joints(rng, size)
        img = render_hand(joints, rng, size)
        imwrite_rgb(os.path.join(rgb_dir, f"{i:06d}.jpg"), img, 95)
        vis = (rng.uniform(size=21) > 0.15).astype(float)
        vis[0] = 1.0
        records[str(i)] = {
            "image_id": f"{i:06d}",
            "coordinates": (joints / size).tolist(),
            "visible": vis.tolist(),
            "pose_ctgy": POSE_CATEGORIES[i % len(POSE_CATEGORIES)],
        }
        if log_every and (i + 1) % log_every == 0:
            rate = (i + 1) / (time.time() - t0)
            print(f"  armo: {i + 1}/{n} ({rate:.0f} img/s)", flush=True)
    anno_path = os.path.join(root, "Armo_hand_dataset", "annotations.json")
    with open(anno_path, "w") as f:
        json.dump(records, f)
    return anno_path


def write_freihand_tsv_tree(root: str, n: int, seed: int,
                            n_shards: int = 2, size: int = 224,
                            log_every: int = 2000) -> str:
    """FreiHAND-format TSV tree: base64-JPEG img TSV shards + label TSV
    (center/scale/2d_joints/3d_joints MANO-era annotation rows) + hw TSV
    + yaml descriptor. Shards exercise concat_tsv_files."""
    import yaml

    from lighthand_tpu_torch.data.tsv import (
        concat_tsv_files,
        img_to_base64,
        tsv_writer,
    )

    out = os.path.join(root, "freihand_synth")
    os.makedirs(out, exist_ok=True)
    per = (n + n_shards - 1) // n_shards
    shard_paths = {"img": [], "label": [], "hw": []}
    t0 = time.time()
    done = 0
    for s in range(n_shards):
        img_rows, label_rows, hw_rows = [], [], []
        for i in range(s * per, min((s + 1) * per, n)):
            rng = np.random.default_rng(seed * 3_000_017 + i)
            joints = synth_hand_joints(rng, size)
            img = render_hand(joints, rng, size)
            key = f"img{i}"
            img_rows.append([key, img_to_base64(img)])
            j3 = np.concatenate(
                [joints / size - 0.5,
                 rng.normal(size=(21, 1)).astype(np.float32)], axis=1)
            anno = {
                "center": [size / 2.0, size / 2.0],
                "scale": size / 200.0,  # 200*scale box == full image
                "has_2d_joints": 1,
                "has_3d_joints": 1,
                "2d_joints": np.concatenate(
                    [joints, np.ones((21, 1), np.float32)],
                    axis=1).tolist(),
                "3d_joints": np.concatenate(
                    [j3, np.ones((21, 1), np.float32)], axis=1).tolist(),
                "has_smpl": 0,
                "pose": np.zeros(72).tolist(),
                "betas": np.zeros(10).tolist(),
            }
            label_rows.append([key, json.dumps([anno])])
            hw_rows.append([key, json.dumps([{"height": size,
                                              "width": size}])])
            done += 1
            if log_every and done % log_every == 0:
                print(f"  frei: {done}/{n} "
                      f"({done / (time.time() - t0):.0f} img/s)", flush=True)
        for kind, rows in (("img", img_rows), ("label", label_rows),
                           ("hw", hw_rows)):
            path = os.path.join(out, f"shard{s}.{kind}.tsv")
            tsv_writer(rows, path)
            shard_paths[kind].append(path)
    for kind in ("img", "label", "hw"):
        concat_tsv_files(shard_paths[kind],
                         os.path.join(out, f"train.{kind}.tsv"))
    desc = {"img": "train.img.tsv", "label": "train.label.tsv",
            "hw": "train.hw.tsv"}
    ypath = os.path.join(out, "train.yaml")
    with open(ypath, "w") as f:
        yaml.safe_dump(desc, f)
    return ypath


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=20000)
    p.add_argument("--n-eval", type=int, default=2000)
    p.add_argument("--n-armo", type=int, default=971)
    p.add_argument("--n-frei", type=int, default=0)
    p.add_argument("--seed", type=int, default=9001)
    a = p.parse_args(argv)

    print(f"writing synthetic LightHand tree under {a.out}", flush=True)
    if a.n_train:
        write_lighthand_tree(a.out, "train", a.n_train, a.seed)
    if a.n_eval:
        write_lighthand_tree(a.out, "eval", a.n_eval, a.seed + 77)
    if a.n_armo:
        write_armo_tree(a.out, a.n_armo, a.seed + 555)
    if a.n_frei:
        y = write_freihand_tsv_tree(a.out, a.n_frei, a.seed + 999)
        print(f"frei yaml: {y}", flush=True)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
