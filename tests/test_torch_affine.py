"""The port's on-device affine ops (``lighthand_tpu_torch/ops/affine.py``)
against the JAX package's (``lighthand_tpu/ops/affine.py``), on the CPU,
from numpy inputs made from a seed.

Tolerances:

- flips (``flip_img``, ``hflip_px``) are exact;
- warps within 5e-5 on [0, 1] values: the two frameworks' f32 ``cos`` and
  ``sin`` may differ by an ulp, which moves a bilinear weight by ~1e-5 at
  255 px (measured on the CPU: 0, warps and rotations up to 256x256);
- joints within 1e-4 px (measured on the CPU: 0);
- ``resize_bilinear`` within 1e-6 (measured 1.2e-7: both are the triangle
  filter, widened by the scale where the image shrinks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.ops import affine as jaff
from lighthand_tpu_torch.ops import affine as aff

T = torch.from_numpy
WARP_ATOL = 5e-5
JOINT_ATOL = 1e-4


def _img(rng, *shape):
    return rng.uniform(0, 1, size=shape).astype(np.float32)


def _random_mats(rng, b, h, w):
    """Out->in matrices: rotation, scale and shear with translations that
    send part of the output outside the image."""
    mats = np.zeros((b, 3, 3), np.float32)
    for i in range(b):
        a = rng.uniform(-np.pi, np.pi)
        s = rng.uniform(0.6, 1.6)
        sh = rng.uniform(-0.3, 0.3)
        mats[i, :2, :2] = s * np.array([[np.cos(a), -np.sin(a) + sh],
                                        [np.sin(a), np.cos(a)]])
        mats[i, :2, 2] = rng.uniform(-0.5, 1.5, 2) * (w, h)
        mats[i, 2, 2] = 1.0
    return mats


@pytest.mark.parametrize("h,w,oh,ow", [(32, 48, 32, 48), (31, 47, 40, 25),
                                       (1, 1, 3, 3), (17, 16, 17, 16)])
def test_affine_warp_matches_jax(h, w, oh, ow):
    rng = np.random.default_rng(h * w)
    img = _img(rng, h, w, 3)
    for m in _random_mats(rng, 3, h, w):
        got = aff.affine_warp(T(img), T(m), (oh, ow)).numpy()
        want = np.asarray(jaff.affine_warp(jnp.asarray(img), jnp.asarray(m),
                                           (oh, ow)))
        assert got.shape == want.shape == (oh, ow, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)


@pytest.mark.parametrize("shift", [(0.0, 0.0), (3.0, -2.0), (-1.0, 0.0),
                                   (47.0, 31.0)])
def test_affine_warp_integer_translations_and_borders(shift):
    """Integer sample coordinates (a weight of exactly 0) and the 1-pixel
    border, where one tap of four lies outside the image."""
    rng = np.random.default_rng(1)
    img = _img(rng, 32, 48, 3)
    m = np.array([[1, 0, shift[0]], [0, 1, shift[1]], [0, 0, 1]], np.float32)
    got = aff.affine_warp(T(img), T(m), (32, 48)).numpy()
    want = np.asarray(jaff.affine_warp(jnp.asarray(img), jnp.asarray(m),
                                       (32, 48)))
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)
    dx, dy = int(shift[0]), int(shift[1])
    ys, xs = np.arange(32)[:, None] + dy, np.arange(48)[None] + dx
    inside = (ys >= 0) & (ys < 32) & (xs >= 0) & (xs < 48)
    expect = np.where(inside[..., None],
                      img[np.clip(ys, 0, 31), np.clip(xs, 0, 47)], 0)
    np.testing.assert_array_equal(got, expect)


def test_affine_warp_batch_matches_jax():
    rng = np.random.default_rng(2)
    imgs = _img(rng, 4, 33, 20, 3)
    mats = _random_mats(rng, 4, 33, 20)
    got = aff.affine_warp_batch(T(imgs), T(mats), (21, 34)).numpy()
    want = np.asarray(jaff.affine_warp_batch(jnp.asarray(imgs),
                                             jnp.asarray(mats), (21, 34)))
    np.testing.assert_allclose(got, want, rtol=0, atol=WARP_ATOL)
    u8 = rng.integers(0, 256, size=(2, 9, 7, 3), dtype=np.uint8)
    got8 = aff.affine_warp_batch(T(u8), T(mats[:2]), (9, 7)).numpy()
    want8 = np.asarray(jaff.affine_warp_batch(jnp.asarray(u8),
                                              jnp.asarray(mats[:2]), (9, 7)))
    assert got8.dtype == np.float32
    np.testing.assert_allclose(got8, want8, rtol=0, atol=255 * WARP_ATOL)


@pytest.mark.parametrize("h,w,cols", [(64, 64, 2), (63, 65, 3), (16, 24, 3)])
def test_rotate_px_batch_matches_jax(h, w, cols):
    rng = np.random.default_rng(h + w + cols)
    imgs = _img(rng, 5, h, w, 3)
    joints = rng.uniform(-4, max(h, w) + 4, size=(5, 21, cols))
    if cols == 3:
        joints[..., 2] = rng.integers(0, 2, size=(5, 21))
    joints = joints.astype(np.float32)
    deg = np.array([0.0, 15.0, -15.0, 90.0, -7.3], np.float32)
    got_i, got_j = aff.rotate_px_batch(T(imgs), T(joints), T(deg))
    want_i, want_j = jaff.rotate_px_batch(jnp.asarray(imgs),
                                          jnp.asarray(joints),
                                          jnp.asarray(deg))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0,
                               atol=WARP_ATOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0,
                               atol=JOINT_ATOL)
    np.testing.assert_array_equal(got_j.numpy()[..., 2:], joints[..., 2:])
    # 0 degrees is the identity on the image and the joints
    np.testing.assert_array_equal(got_i.numpy()[0], imgs[0])
    np.testing.assert_allclose(got_j.numpy()[0], joints[0], atol=1e-5)


@pytest.mark.parametrize("cols", [2, 3])
def test_hflip_px_matches_jax_exactly(cols):
    rng = np.random.default_rng(cols)
    imgs = _img(rng, 4, 12, 9, 3)
    joints = rng.uniform(0, 9, size=(4, 21, cols)).astype(np.float32)
    mask = np.array([True, False, True, False])
    got_i, got_j = aff.hflip_px(T(imgs), T(joints), T(mask))
    want_i, want_j = jaff.hflip_px(jnp.asarray(imgs), jnp.asarray(joints),
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    np.testing.assert_array_equal(got_i.numpy()[1], imgs[1])
    np.testing.assert_array_equal(got_j.numpy()[0, :, 0],
                                  8.0 - joints[0, :, 0])
    assert aff.HAND_FLIP_PERM == jaff.HAND_FLIP_PERM


def test_flip_img_matches_jax_exactly():
    img = _img(np.random.default_rng(3), 5, 8, 3)
    got = aff.flip_img(T(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaff.flip_img(
        jnp.asarray(img))))
    np.testing.assert_array_equal(got, img[:, ::-1])


@pytest.mark.parametrize("hw,out", [((37, 50), (64, 80)), ((64, 80), (37, 50)),
                                    ((33, 33), (16, 16)), ((37, 50), (64, 30)),
                                    ((16, 16), (16, 16))],
                         ids=["up", "down", "down_odd", "mixed", "same"])
def test_resize_bilinear_matches_jax(hw, out):
    rng = np.random.default_rng(hw[0] + out[1])
    img = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    got = aff.resize_bilinear(T(img), out).numpy()
    want = np.asarray(jaff.resize_bilinear(jnp.asarray(img), out))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-6)
