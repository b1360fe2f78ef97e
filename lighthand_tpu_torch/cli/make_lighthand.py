"""LightHand dataset generator post-processing.

Counterpart of ``lighthand_tpu/cli/make_lighthand.py`` (the reference's
offline converter, src/tools/processing_aug.py:22-136): takes raw
"ArmHand" captures (CISLAB camera/joint_3d/data JSONs + images), and per
frame

1. projects 3D world joints through the camera (rot @ (p - campos),
   perspective divide, * focal + principal point at input_size/2);
2. drops frames with any joint outside [20, 200] px;
3. applies a random roll in [-20, 20] deg about the image center plus a
   "black border lift" (the wrist edge of the crop rotates up and exposes
   black rows at the bottom, so the image is shifted down by the rotated
   height of the lowest wrist corner, processing_aug.py:75-89), plus a
   uniform [0, 17] px y-translation;
4. writes the rotated JPEG and appends {file_name, joint_2d} to
   CISLAB_{phase}_data.json.

For the same input tree and seed the output tree equals the JAX CLI's,
byte for byte (the JSON names paths under ``--out``), without OpenCV:
images are read with the port's decoder (``cv2.imread``'s
``IMREAD_COLOR`` with the EXIF orientation applied), warped with
``cv2.warpAffine``'s own inversion of the forward matrix followed by the
port's inverse-map warp, and written by the port's encoder at cv2's
default quality 95. ``random`` is Python's, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import sys

import numpy as np

from lighthand_tpu_torch.data.imageio import (
    ImageDecodeError,
    imread_rgb,
    imwrite_rgb,
    warp_affine_inverse,
)


def project_to_camera(joint_world: np.ndarray, camrot: np.ndarray,
                      campos: np.ndarray, focal: float,
                      half_size: float) -> np.ndarray:
    """world [21,3] -> pixel [21,2] (processing_aug.py:59-64)."""
    cam = (camrot @ (joint_world - campos).T).T
    px = cam[:, :2] / cam[:, 2:3]
    return px * focal + half_size


def lift_for_rotation(rad: float, half_size: float) -> float:
    """Black-border compensation (processing_aug.py:74-89): rotate the two
    lowest wrist corners (x=79,174 at y=0 in crop coords) and lift by
    whichever ends up below the frame."""
    corners = [(79 - half_size, -half_size), (174 - half_size, -half_size)]
    for cx, cy in corners:
        rot_y = math.cos(rad) * cy - math.sin(rad) * cx + half_size
        if rot_y > 0:
            return rot_y
    return 0.0


def rotate_joints(joints: np.ndarray, rad: float, half_size: float,
                  dy: float) -> np.ndarray:
    """In-plane roll about the center + y shift; the reference rotates y
    using the ALREADY-rotated x (processing_aug.py:94-97), kept, since the
    images it produced were rotated consistently with these labels."""
    out = joints.copy()
    cx = out[:, 0] - half_size
    cy = out[:, 1] - half_size
    out[:, 0] = math.cos(rad) * cx + math.sin(rad) * cy + half_size
    rx = out[:, 0] - half_size  # rotated x, as in the reference
    out[:, 1] = (math.cos(rad) * cy - math.sin(rad) * rx
                 + half_size + dy)
    return out


def rotation_matrix_2d(center, degrees: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, degrees, 1.0)``: the forward 2x3
    map, in double precision."""
    angle = degrees * (math.pi / 180)
    alpha = math.cos(angle)
    beta = math.sin(angle)
    cx, cy = float(center[0]), float(center[1])
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """The inverse ``cv2.warpAffine`` takes of a forward 2x3 map (without
    ``WARP_INVERSE_MAP``), operation for operation in double precision."""
    m0, m1, m2, m3, m4, m5 = (float(v) for v in np.asarray(m).reshape(6))
    d = m0 * m4 - m1 * m3
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m4 * d, m0 * d
    m0, m1, m3, m4 = a11, m1 * -d, m3 * -d, a22
    b1 = -m0 * m2 - m1 * m5
    b2 = -m3 * m2 - m4 * m5
    return np.array([[m0, m1, b1], [m3, m4, b2]])


def rotate_translate_image(img: np.ndarray, degrees: float,
                           dy: float) -> np.ndarray:
    """Rotate about the center then translate, as one warp (the reference's
    i_rotate chained two warpAffines, processing_aug.py:125-136)."""
    h, w = img.shape[:2]
    m = rotation_matrix_2d((int(w / 2), int(h / 2)), degrees)
    m[1, 2] += dy
    return warp_affine_inverse(img, invert_affine(m), (w, h))


def in_frame(joints: np.ndarray, lo: float = 20.0, hi: float = 200.0) -> bool:
    return bool(np.all((joints >= lo) & (joints <= hi)))


def process_split(root: str, out_root: str, phase: str,
                  input_size: int = 224, seed: int = 9001) -> int:
    half = input_size / 2
    random.seed(seed)

    anno_dir = os.path.join(root, "annotations", phase)
    with open(os.path.join(anno_dir, f"CISLAB_{phase}_camera.json")) as f:
        camera = json.load(f)
    with open(os.path.join(anno_dir, f"CISLAB_{phase}_joint_3d.json")) as f:
        joint3d = json.load(f)
    with open(os.path.join(anno_dir, f"CISLAB_{phase}_data.json")) as f:
        meta = json.load(f)
    img_root = os.path.join(root, "images", phase, "Capture0")

    out = []
    for rec in meta["images"]:
        cam = rec["camera"]
        if cam == "0":
            continue
        frame = rec["frame_idx"]
        world = np.asarray(joint3d["0"][f"{frame}"]["world_coord"][:21],
                           np.float64)
        focal = float(camera["0"]["focal"][f"{cam}"][0])
        campos = np.asarray(camera["0"]["campos"][f"{cam}"], np.float64)
        camrot = np.asarray(camera["0"]["camrot"][f"{cam}"], np.float64)

        joints = project_to_camera(world, camrot, campos, focal, half)
        if not in_frame(joints):
            continue

        degrees = random.uniform(-20, 20)
        rad = math.radians(degrees)
        dy = lift_for_rotation(rad, half) + random.uniform(0, 17)
        joints = rotate_joints(joints, rad, half, dy)
        if not in_frame(joints):
            continue

        rel = "/".join(rec["file_name"].split("/")[1:])
        src = os.path.join(img_root, rel)
        try:  # cv2.imread gives None for a missing or unreadable file
            img = imread_rgb(src)
        except (OSError, ImageDecodeError):
            continue
        rot = rotate_translate_image(img, degrees, dy)

        dst = os.path.join(out_root, "images", phase, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        imwrite_rgb(dst, rot)
        out.append({"file_name": dst, "joint_2d": joints.tolist()})

    store = os.path.join(out_root, "annotations", phase,
                         f"CISLAB_{phase}_data.json")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    with open(store, "w") as f:
        json.dump(out, f)
    print(f"Done ===> {store} ({len(out)} frames)")
    return len(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="../../dataset/ArmHand")
    p.add_argument("--out", default="../../dataset/LightHand")
    p.add_argument("--phase", default="train2")
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=9001)
    a = p.parse_args(argv)
    process_split(a.root, a.out, a.phase, a.input_size, a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
