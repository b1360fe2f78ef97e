"""The port's tree-making CLIs (``lighthand_tpu_torch/cli/make_synth_data.py``,
``cli/make_lighthand.py``) and ``data/tsv.py:img_to_base64`` against the
JAX package's, which write through cv2.

Tolerance: none. For the same arguments the port's trees equal the JAX
CLIs' file for file, byte for byte (JSON files name paths under the output
root, so they are compared with the root replaced). The digests of the
trees that ``chip_smoke.py`` phases 9a and 9e make on the card are stored
in ``tests/fixtures/make_synth_digests.json`` (written from the JAX CLIs
by ``tests/fixtures/make_digests.py``); the port's trees must give them.
"""

import base64
import json
import math
import os

import cv2
import numpy as np
import pytest

import chip_smoke
from lighthand_tpu.cli import make_lighthand as jax_ml
from lighthand_tpu.cli import make_synth_data as jax_synth
from lighthand_tpu.data.tsv import img_to_base64 as jax_b64
from lighthand_tpu_torch.cli import make_lighthand as ml
from lighthand_tpu_torch.cli import make_synth_data as synth
from lighthand_tpu_torch.data.tsv import img_from_base64, img_to_base64

SMALL = ["--n-train", "3", "--n-eval", "2", "--n-armo", "5", "--n-frei", "3"]


def _digests():
    with open(chip_smoke.DIGESTS) as f:
        return json.load(f)


def _same_tree(got_root: str, want_root: str) -> list:
    """Files of the two trees, asserted equal (JSON up to the root)."""
    got = chip_smoke.tree_digests(got_root)
    want = chip_smoke.tree_digests(want_root)
    assert list(got) == list(want)
    for rel in got:
        assert got[rel] == want[rel], rel
    return list(got)


# ------------------------------------------------------- make_synth_data


def test_synth_tree_equals_jax_cli(tmp_path):
    """All four writers (LightHand train and eval, Armo, FreiHAND TSV with
    two shards and their concatenation) at small n."""
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert synth.main(["--out", port, *SMALL]) == 0
    assert jax_synth.main(["--out", jax, *SMALL]) == 0
    files = _same_tree(port, jax)
    assert len(files) == 3 + 2 + 2 + 5 + 1 + 3 * 2 * 3 + 1
    assert "freihand_synth/train.lineidx" not in files  # per-kind sidecars
    assert "freihand_synth/train.img.lineidx" in files


def test_synth_tree_matches_stored_digests(tmp_path):
    """``chip_smoke.SYNTH_ARGS``' tree (phase 9a's) against the digests of
    the JAX CLI's tree."""
    want = _digests()["make_synth_data"]
    assert want["args"] == list(chip_smoke.SYNTH_ARGS)
    out = str(tmp_path / "synth")
    assert synth.main(["--out", out, *chip_smoke.SYNTH_ARGS]) == 0
    assert chip_smoke.tree_digests(out) == want["files"]


def test_resume_fast_path_keeps_existing_images(tmp_path, monkeypatch):
    """An image already on disk is a pure function of (seed, i): it is not
    rendered again, and its joints still go into the annotations."""
    root = str(tmp_path)
    synth.write_lighthand_tree(root, "train", 3, seed=5)
    img_dir = os.path.join(root, "LightHand", "images", "train")
    kept = open(os.path.join(img_dir, "0000001.jpg"), "rb").read()
    os.remove(os.path.join(img_dir, "0000002.jpg"))
    anno = os.path.join(root, "LightHand", "annotations", "train",
                        "CISLAB_train_data.json")
    before = json.load(open(anno))
    rendered = []
    real = synth.render_hand

    def counting(joints, rng, size):
        rendered.append(size)
        return real(joints, rng, size)

    monkeypatch.setattr(synth, "render_hand", counting)
    synth.write_lighthand_tree(root, "train", 3, seed=5)
    assert rendered == [224]  # only the missing image
    assert open(os.path.join(img_dir, "0000001.jpg"), "rb").read() == kept
    assert json.load(open(anno)) == before


def test_img_to_base64_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, size=(37, 29, 3), dtype=np.uint8)
    got = img_to_base64(img)
    assert got == jax_b64(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert img_to_base64(img, 60) == jax_b64(
        cv2.cvtColor(img, cv2.COLOR_RGB2BGR), 60)
    back = img_from_base64(got)
    want = cv2.imdecode(np.frombuffer(base64.b64decode(got), np.uint8),
                        cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(back, cv2.cvtColor(want,
                                                     cv2.COLOR_BGR2RGB))


# -------------------------------------------------------- make_lighthand
# the four cases of tests/test_make_lighthand.py, on the port


@pytest.fixture
def fake_armhand(tmp_path, rng):
    """tests/test_make_lighthand.py's capture tree: 8 frames of random
    224x224 images, written by cv2."""
    root = tmp_path / "ArmHand"
    phase = "train"
    anno = root / "annotations" / phase
    os.makedirs(anno)
    img_dir = root / "images" / phase / "Capture0" / "cam1"
    os.makedirs(img_dir)
    images, joints3d = [], {}
    camera = {"0": {"focal": {"1": [500.0, 500.0]},
                    "campos": {"1": [0.0, 0.0, -400.0]},
                    "camrot": {"1": np.eye(3).tolist()}}}
    for i in range(8):
        fname = f"Capture0/cam1/{i:05d}.jpg"
        images.append({"camera": "1", "frame_idx": i, "file_name": fname})
        pts = rng.uniform(-25, 25, size=(21, 3))
        pts[:, 2] = 0.0
        joints3d[str(i)] = {"world_coord": pts.tolist()}
        img = rng.integers(0, 255, size=(224, 224, 3), dtype=np.uint8)
        cv2.imwrite(str(img_dir / f"{i:05d}.jpg"), img)
    (anno / f"CISLAB_{phase}_camera.json").write_text(json.dumps(camera))
    (anno / f"CISLAB_{phase}_joint_3d.json").write_text(
        json.dumps({"0": joints3d}))
    (anno / f"CISLAB_{phase}_data.json").write_text(
        json.dumps({"images": images}))
    return str(root), str(tmp_path / "LightHand"), phase


def test_projection_math():
    world = np.array([[0.0, 0.0, 0.0], [40.0, -40.0, 0.0]])
    px = ml.project_to_camera(world, np.eye(3), np.array([0.0, 0.0, -400.0]),
                              500.0, 112.0)
    np.testing.assert_allclose(px[0], [112.0, 112.0])
    np.testing.assert_allclose(px[1], [162.0, 62.0])


def test_lift_compensation_sign():
    assert ml.lift_for_rotation(math.radians(15), 112.0) > 0
    assert ml.lift_for_rotation(0.0, 112.0) >= 0
    for deg in (-20.0, -3.5, 0.0, 7.25, 20.0):
        rad = math.radians(deg)
        assert ml.lift_for_rotation(rad, 112.0) == jax_ml.lift_for_rotation(
            rad, 112.0)


def test_rotate_joints_identity():
    joints = np.array([[100.0, 100.0], [50.0, 150.0]])
    out = ml.rotate_joints(joints, 0.0, 112.0, dy=5.0)
    np.testing.assert_allclose(out[:, 0], joints[:, 0])
    np.testing.assert_allclose(out[:, 1], joints[:, 1] + 5.0)
    rad = math.radians(13.0)
    np.testing.assert_array_equal(ml.rotate_joints(joints, rad, 112.0, 3.0),
                                  jax_ml.rotate_joints(joints, rad, 112.0,
                                                       3.0))


def test_process_split_end_to_end(fake_armhand):
    root, out_root, phase = fake_armhand
    n = ml.process_split(root, out_root, phase, input_size=224, seed=7)
    assert n > 0
    store = os.path.join(out_root, "annotations", phase,
                         f"CISLAB_{phase}_data.json")
    with open(store) as f:
        recs = json.load(f)
    assert len(recs) == n
    for rec in recs:
        assert os.path.isfile(rec["file_name"])
        joints = np.asarray(rec["joint_2d"])
        assert joints.shape == (21, 2)
        assert ml.in_frame(joints)


def test_process_split_tree_equals_jax(fake_armhand, tmp_path):
    root, _, phase = fake_armhand
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    assert ml.process_split(root, port, phase, 224, 7) == \
        jax_ml.process_split(root, jax, phase, 224, 7) > 0
    _same_tree(port, jax)


def test_process_split_matches_stored_digests(tmp_path):
    """Phase 9e's tree (the fixture JPEGs as captures, a camera-0 record
    and a missing image skipped) against the JAX CLI's digests, through
    ``main``."""
    raw, out = str(tmp_path / "raw"), str(tmp_path / "out")
    phase = chip_smoke.write_armhand_tree(raw)
    want = _digests()["make_lighthand"]
    assert ml.main(["--root", raw, "--out", out, "--phase", phase,
                    "--seed", str(want["seed"])]) == 0
    assert chip_smoke.tree_digests(out) == want["files"]


@pytest.mark.parametrize("seed", range(4))
def test_rotation_warp_matches_cv2(seed):
    """``getRotationMatrix2D`` bit for bit, and the warp without
    ``WARP_INVERSE_MAP`` (cv2 inverts the forward map itself) pixel for
    pixel, at drawn angles, shifts and sizes."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        h, w = (224, 224) if seed == 0 else rng.integers(3, 300, 2)
        deg = float(rng.uniform(-20, 20))
        dy = float(rng.uniform(0, 40))
        center = (int(w / 2), int(h / 2))
        want_m = cv2.getRotationMatrix2D(center, deg, 1.0)
        np.testing.assert_array_equal(ml.rotation_matrix_2d(center, deg),
                                      want_m)
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        want_m[1, 2] += dy
        np.testing.assert_array_equal(
            ml.rotate_translate_image(img, deg, dy),
            cv2.warpAffine(img, want_m, (int(w), int(h))))
