"""Seeded inputs and stored results shared by the port's CPU tests
(``tests/test_torch_*.py``, ``tests/fixtures/make_*.py``) and its two card
scripts, ``chip_smoke.py`` (checks) and ``kernel_breakdown.py`` (times).

- Trees of the committed fixture images (``tests/fixtures/images``) in
  each dataset's layout, the digests of trees and drawings, the drawings
  and captions whose digests are stored, the rasterizer's meshes, and the
  tolerances the geometry ops are held to on either device.
- The kernels' inputs: K1's images, joints and draws, the int8 conv's
  operands and its exact twin, each model's quantized conv and BatchNorm
  shapes (read by hooks), its quantized weights, and BatchNorm operands.

Nothing here imports ``torch`` or the port at import time.
"""

from __future__ import annotations

import itertools
import json
import math
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "images")

B_KERNEL, B_TRAIN, SIZE, JOINTS, HM = 128, 32, 256, 21, 64
ACT_CLIP = 8.0  # the int8_fwd policy's static activation clip


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


# chip_smoke.py phase 9a's make_synth_data arguments, and the digests of
# the tree the JAX package's CLI writes for them
# (tests/fixtures/make_digests.py)
SYNTH_ARGS = ("--n-train", "64", "--n-eval", "32", "--n-armo", "32",
              "--n-frei", "16")
DIGESTS = os.path.join(REPO, "tests", "fixtures", "make_synth_digests.json")


# chip_smoke.py phase 9g's drawings: the digests of what the JAX package
# draws for them with cv2 5.0.0 (tests/fixtures/make_overlay_digests.py)
OVERLAY_DIGESTS = os.path.join(REPO, "tests", "fixtures",
                               "overlay_digests.json")


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


# chip_smoke.py phase 9i's captions: the digests of what the JAX package's
# draw_text and cv2 5.0.0's FontFace putText draw
# (tests/fixtures/make_text_digests.py)
TEXT_DIGESTS = os.path.join(REPO, "tests", "fixtures", "text_digests.json")


def text_drawings(draw_text, put_text) -> dict:
    """{name: array} of phase 9i's captions, made with ``draw_text(image,
    content)`` and ``put_text(img, text, org, color, size, weight)`` (which
    returns the pen's end) from seeded inputs: ``draw_text`` on four float
    images with black letterbox margins and values out of [0, 1], with
    float, numpy float, int, str and bool values and enough rows to run off
    the bottom; ``put_text`` at sizes 8-24 and weights 300-900 over random
    backgrounds and colours, with origins that cut the text at each edge,
    on a 1x1 and a 17x13 image too; the pens' ends as one array."""
    import numpy as np

    rng = np.random.default_rng(23)
    out = {}
    for i, (h, w) in enumerate(((96, 128), (64, 200), (40, 90), (256, 256))):
        img = rng.uniform(-0.2, 1.2, (h, w, 3))
        img[:6 + 4 * i] = 0.0
        img[:, :5 + i] = 0.0
        content = {"pck": float(rng.uniform()), "auc": np.float64(0.5),
                   "loss": np.float32(rng.uniform()), "epoch": i,
                   "name": "hand", "ok": bool(i % 2)}
        for k in range(3 * i):
            content[f"row{k}"] = float(rng.uniform(-10, 10))
        out[f"draw_text_{i}"] = draw_text(img, content)
    letters = ("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
               "0123456789 !\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
               "\u00c0\u00c5\u00c9\u00d1\u00d6\u00df\u00e5\u00e7"
               "\u00ea\u00f1\u00f6\u00ff")
    pens = []
    cases = [((40, 140), 8, 300, (4, 30)), ((40, 140), 11, 400, (-6, 12)),
             ((40, 140), 16, 550, (90, 45)), ((48, 160), 24, 700, (10, 8)),
             ((40, 140), 13, 900, (30, 38)), ((40, 140), 20, 400, (120, 20)),
             ((1, 1), 11, 400, (0, 5)), ((13, 17), 11, 400, (-2, 10))]
    for k, (shape, size, weight, org) in enumerate(cases):
        canvas = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        text = "".join(rng.choice(list(letters), 14))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        pens.append(put_text(canvas, text, org, color, size, weight))
        out[f"put_text_{k}_{size}_{weight}"] = canvas
    out["put_text_pens"] = np.array(pens, dtype=np.int64)
    return out


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


# the renderer's two sizes: W, H, focal
RENDER_SIZES = ((800, 600, 5000.0), (224, 224, 1500.0))


# the CPU tests' tolerances (tests/test_torch_geometry.py)
GEOMETRY_RTOL, GEOMETRY_ATOL = 1e-5, 1e-6
PROCRUSTES_ATOL = 1e-4


# --------------------------------------------------------- kernel inputs


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


def heaviest_shape(uses: dict):
    """The conv shape of a model with the most operations a forward."""
    return max(uses, key=lambda key: conv_ops(B_TRAIN, key) * uses[key])


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


# the cells' models and batches: HRNet-W32 at bs128 (w32.train.b128,
# w32.eval.b128), ResNet-50 at bs32 (r50.train.b32, r50.eval.b32.int8)
BN_MODELS = (("hrnet_w32", 128), ("resnet50", 32))


def bn_shapes(name: str) -> dict:
    """{(C, H, W, relu, residual): uses} of the BatchNorms of one forward
    of ``name`` at 256x256, read by forward hooks on a batch of one
    (``residual``: the call ends a residual block)."""
    import torch

    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.models.layers import BatchNorm2d

    model = get_model(name).cuda().eval()
    uses = {}

    def hook(module, inputs, kwargs, output):
        _, c, h, w = inputs[0].shape
        key = (c, h, w, module.relu, kwargs.get("residual") is not None)
        uses[key] = uses.get(key, 0) + 1

    handles = [m.register_forward_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        model(torch.zeros(1, 3, SIZE, SIZE, device="cuda"))
    for h in handles:
        h.remove()
    return uses


def bn_inputs(n: int, c: int, h: int, w: int, dtype, seed: int):
    """x and dy in ``channels_last`` memory, f32 weight, bias and running
    statistics, made from ``seed``."""
    import torch

    g = torch.Generator().manual_seed(seed)

    def act(mean, std):
        t = torch.randn(n, c, h, w, generator=g) * std + mean
        return t.to(dtype).cuda().contiguous(memory_format=torch.channels_last)

    x, dy = act(0.7, 2.0), act(0.0, 1.0)
    weight = (torch.rand(c, generator=g) + 0.5).cuda()
    bias = (torch.randn(c, generator=g) * 0.3).cuda()
    rm = (torch.randn(c, generator=g) * 0.1).cuda()
    rv = (torch.rand(c, generator=g) + 0.5).cuda()
    return x, dy, weight, bias, rm, rv
