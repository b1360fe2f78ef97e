"""The port's overlays (``lighthand_tpu_torch/utils/visualize.py``) against
the JAX package's (``lighthand_tpu/utils/visualize.py``, which draws with
cv2), and ``ops/color.py:denormalize_imagenet`` against JAX's.

Tolerance: none. ``draw_joints`` must give the same pixels for joints on,
off and around the image (negative, past the edge, on the edge), the
drawing primitives the same pixels as cv2's circle and line on drawn
cases, and ``save_overlay`` the same file bytes (denormalize, truncating
cast, GT | prediction side by side, JPEG at quality 95). The thick
primitives of the landmark and skeleton overlays (``draw_line`` with a
thickness, ``draw_circle`` as an outline, ``draw_arrowed_line``) give
cv2's pixels, clipping at the image border included, over drawn ends,
radii and thicknesses, points far off the image among them.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lighthand_tpu.ops.color import denormalize_imagenet as jax_denorm
from lighthand_tpu.utils import visualize as jv
from lighthand_tpu_torch.ops.color import denormalize_imagenet
from lighthand_tpu_torch.utils import visualize as tv

SETTINGS = settings(max_examples=60, deadline=None, derandomize=True)


def _joints(rng, lo, hi, n=21):
    return rng.uniform(lo, hi, size=(n, 2)).astype(np.float32)


def _norm_image(rng, h, w):
    return rng.normal(0.0, 1.2, size=(h, w, 3)).astype(np.float32)


def test_parents_match_jax():
    np.testing.assert_array_equal(tv.PARENTS, jv.PARENTS)


def test_denormalize_matches_jax():
    x = _norm_image(np.random.default_rng(0), 17, 23)
    got = denormalize_imagenet(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_denorm(x)))
    assert got.dtype == np.float32


@SETTINGS
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       lo=st.integers(-80, 40), span=st.integers(1, 160),
       seed=st.integers(0, 2**31 - 1))
def test_draw_joints_matches_jax(h, w, lo, span, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    joints = _joints(rng, lo, lo + span)
    np.testing.assert_array_equal(tv.draw_joints(img, joints),
                                  jv.draw_joints(img, joints))


@pytest.mark.parametrize("case", ["edges", "corners", "negative", "far",
                                  "one_pixel", "with_visibility"])
def test_draw_joints_edge_cases_match_jax(case):
    rng = np.random.default_rng(1)
    h, w = (1, 1) if case == "one_pixel" else (32, 40)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    if case == "edges":
        joints = np.stack([rng.choice([0, w - 1, w, -1], 21),
                           rng.uniform(0, h, 21)], -1)
    elif case == "corners":
        joints = np.array([[0, 0], [w - 1, 0], [0, h - 1],
                           [w - 1, h - 1]] * 6, np.float32)[:21]
    elif case == "negative":
        joints = _joints(rng, -9.9, 0.9)  # int() truncates toward zero
    elif case == "far":
        joints = _joints(rng, -3000, 3000)
    elif case == "one_pixel":
        joints = _joints(rng, -2, 3)
    else:
        joints = np.concatenate([_joints(rng, 0, 40),
                                 np.ones((21, 1), np.float32)], -1)
    np.testing.assert_array_equal(tv.draw_joints(img, joints),
                                  jv.draw_joints(img, joints))


@SETTINGS
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       pts=st.lists(st.integers(-120, 160), min_size=4, max_size=4),
       radius=st.integers(0, 6))
def test_line_and_circle_match_cv2(h, w, pts, radius):
    img = np.zeros((h, w, 3), np.uint8)
    want = img.copy()
    p1, p2 = tuple(pts[:2]), tuple(pts[2:])
    tv.fill_circle(img, p1, radius, (255, 255, 255))
    tv.draw_line(img, p1, p2, (1, 2, 3))
    cv2.circle(want, p1, radius, (255, 255, 255), -1)
    cv2.line(want, p1, p2, (1, 2, 3), 1)
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("panels", ["both", "gt_only", "pred_only"])
def test_save_overlay_bytes_match_jax(tmp_path, panels):
    rng = np.random.default_rng(2)
    img = _norm_image(rng, 64, 48)
    gt = np.concatenate([_joints(rng, -5, 70), np.ones((21, 1))], -1)
    pred = _joints(rng, 0, 64)
    gt_arg = None if panels == "pred_only" else gt
    pred_arg = None if panels == "gt_only" else pred
    got = tv.save_overlay(img, gt_arg, pred_arg, str(tmp_path / "port"),
                          "val", 3, 7)
    want = jv.save_overlay(img, gt_arg, pred_arg, str(tmp_path / "jax"),
                           "val", 3, 7)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(
        want, tmp_path / "jax") == os.path.join("val_image", "3_epoch",
                                                "iter_7.jpg")
    assert open(got, "rb").read() == open(want, "rb").read()
    width = 96 if panels == "both" else 48
    assert cv2.imread(got).shape == (64, width, 3)


def test_save_overlay_of_bf16_image_matches_jax(tmp_path):
    """The Trainer's rows are bf16 on the card: the port copies the row to
    the host as f32, JAX's ``np.asarray`` gives bf16 that denormalize
    casts; the overlay is the same."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    img = torch.from_numpy(_norm_image(rng, 32, 32)).bfloat16()
    joints = _joints(rng, 0, 32)
    got = tv.save_overlay(img.float().numpy(), joints, joints,
                          str(tmp_path), "train", 0, 0)
    jax_img = img.float().numpy().astype(ml_dtypes.bfloat16)
    want = jv.save_overlay(jax_img, joints, joints, str(tmp_path / "j"),
                           "train", 0, 0)
    assert open(got, "rb").read() == open(want, "rb").read()


THICK = settings(max_examples=120, deadline=None, derandomize=True)
_POINT = st.tuples(st.integers(-300, 300), st.integers(-300, 300))


@THICK
@given(h=st.integers(1, 64), w=st.integers(1, 64), p1=_POINT, p2=_POINT,
       thickness=st.integers(2, 5), near=st.booleans())
def test_thick_line_matches_cv2(h, w, p1, p2, thickness, near):
    if near:  # both ends within a few pixels of the image
        p1, p2 = (p1[0] % (w + 8) - 4, p1[1] % (h + 8) - 4), \
            (p2[0] % (w + 8) - 4, p2[1] % (h + 8) - 4)
    img = np.zeros((h, w, 3), np.uint8)
    want = img.copy()
    tv.draw_line(img, p1, p2, (10, 20, 30), thickness)
    cv2.line(want, p1, p2, (10, 20, 30), thickness)
    np.testing.assert_array_equal(img, want)


@THICK
@given(h=st.integers(1, 64), w=st.integers(1, 64), c=_POINT,
       radius=st.integers(0, 40), thickness=st.integers(1, 5))
def test_outline_circle_matches_cv2(h, w, c, radius, thickness):
    c = (c[0] % (w + 2 * radius + 8) - radius - 4,
         c[1] % (h + 2 * radius + 8) - radius - 4)
    img = np.zeros((h, w, 3), np.uint8)
    want = img.copy()
    tv.draw_circle(img, c, radius, (10, 20, 30), thickness)
    cv2.circle(want, c, radius, (10, 20, 30), thickness)
    np.testing.assert_array_equal(img, want)


@THICK
@given(h=st.integers(1, 64), w=st.integers(1, 64), p1=_POINT, p2=_POINT,
       thickness=st.integers(1, 5))
def test_arrowed_line_matches_cv2(h, w, p1, p2, thickness):
    p1 = (p1[0] % (w + 40) - 20, p1[1] % (h + 40) - 20)
    img = np.zeros((h, w, 3), np.uint8)
    want = img.copy()
    tv.draw_arrowed_line(img, p1, p2, (10, 20, 30), thickness)
    cv2.arrowedLine(want, p1, p2, (10, 20, 30), thickness)
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("case", ["point", "far", "filled", "radius_0",
                                  "big_radius"])
def test_thick_primitive_edge_cases_match_cv2(case):
    """A zero-length thick line (the two end caps alone), ends thousands of
    pixels off the image, a negative thickness (filled), radius 0, and a
    radius whose polygon takes the 5-degree step."""
    img = np.zeros((40, 50, 3), np.uint8)
    want = img.copy()
    if case == "point":
        tv.draw_line(img, (20, 20), (20, 20), (1, 2, 3), 5)
        cv2.line(want, (20, 20), (20, 20), (1, 2, 3), 5)
    elif case == "far":
        tv.draw_line(img, (-4000, 3000), (5000, -2500), (1, 2, 3), 4)
        cv2.line(want, (-4000, 3000), (5000, -2500), (1, 2, 3), 4)
        tv.draw_arrowed_line(img, (-900, 25), (60, 12), (4, 5, 6), 3)
        cv2.arrowedLine(want, (-900, 25), (60, 12), (4, 5, 6), 3)
    elif case == "filled":
        tv.draw_circle(img, (3, 37), 9, (1, 2, 3), -1)
        cv2.circle(want, (3, 37), 9, (1, 2, 3), -1)
    elif case == "radius_0":
        for t in (1, 2, 3):
            tv.draw_circle(img, (10 * t, 20), 0, (1, 2, 3), t)
            cv2.circle(want, (10 * t, 20), 0, (1, 2, 3), t)
    else:
        tv.draw_circle(img, (25, 60), 47, (1, 2, 3), 3)
        cv2.circle(want, (25, 60), 47, (1, 2, 3), 3)
    np.testing.assert_array_equal(img, want)


def test_sin_table_is_opencvs():
    """The circle polygon's sine table equals the one cv2's
    ``ellipse2Poly`` uses, read from it at axes of 2^30 (exact in f64)."""
    axis = 2 ** 30
    pts = cv2.ellipse2Poly((0, 0), (axis, axis), 0, 0, 360, 1)
    assert len(pts) == 361
    for deg, (x, y) in enumerate(pts):
        assert tv._SIN_TABLE[450 - deg] * axis == x
        assert tv._SIN_TABLE[deg] * axis == y
