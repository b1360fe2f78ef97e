"""The port's ops and the plain twins of its CUDA kernels against the JAX
package, on the same numpy inputs (CPU).

The Pallas kernels run as tests/test_pallas.py runs them: interpret mode.
The fused aug kernel is compared through the JAX ``_kernel`` itself, wrapped
here in a ``pl.pallas_call`` with the BlockSpecs of
``lighthand_tpu/ops/pallas/fused_aug.py:199-222`` and injected draws.

Tolerances: targets atol 1e-5 (tests/test_pallas.py:16); f32 color ops
atol 1e-5 (the frameworks compute the same formulas, but a mean or a dot
sums in another order); bf16 images within 1 bf16 ulp of the JAX value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lighthand_tpu.ops import color as jcolor
from lighthand_tpu.ops import decode as jdecode
from lighthand_tpu.ops import metrics as jmetrics
from lighthand_tpu.ops.heatmap import generate_target_batch as jax_targets
from lighthand_tpu.ops.pallas import fused_aug as jfused
from lighthand_tpu.ops.pallas.heatmap import generate_target_batch_pallas
from lighthand_tpu_torch.ops import color, decode, heatmap, metrics
from lighthand_tpu_torch.ops.kernels import _build
from lighthand_tpu_torch.ops.kernels.fused_aug import (
    draw_aug_params,
    fused_aug_targets_cuda,
    fused_aug_targets_plain,
)
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda

T = torch.from_numpy


# --------------------------------------------------------------- heatmaps


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_heatmap_matches_jax_and_pallas(seed):
    joints = np.random.default_rng(seed).uniform(
        -40, 300, size=(4, 21, 2)).astype(np.float32)
    got = heatmap.generate_target_batch(T(joints)).numpy()
    want = np.asarray(jax_targets(jnp.asarray(joints)))
    pallas = np.asarray(generate_target_batch_pallas(jnp.asarray(joints),
                                                     interpret=True))
    assert got.shape == (4, 21, 64, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    assert (got.reshape(4, 21, -1).max(-1) == 0).any()  # dropped joints


def test_pack_centers_truncates_toward_zero():
    joints = T(np.array([[[-3.0, -1.9], [1.9, 6.1], [255.0, -26.5]]],
                        np.float32))
    packed = heatmap.pack_centers(joints)
    # -3/4+0.5 = -0.25 -> 0 (floor would give -1); -26.5/4+0.5 = -6.125 -> -6
    np.testing.assert_array_equal(packed[0, :, :2].numpy(),
                                  [[0, 0], [0, 2], [64, -6]])
    # ul_x = 64-6 = 58 < 64 keeps joint 2; br_y = -6+7 = 1 >= 0 keeps it too
    np.testing.assert_array_equal(packed[0, :, 2].numpy(), [1, 1, 1])


def test_stride_3_targets_match_jax():
    """At stride 3 a reciprocal multiply would quantise 241.49998 to 81;
    the twin divides, as the JAX package and the kernels do, and gives 80."""
    rng = np.random.default_rng(5)
    joints = rng.uniform(-40, 300, size=(3, 21, 2)).astype(np.float32)
    joints[0, :4] = [[241.49998, 4.5], [1.5, 241.49998], [-1.5, 7.5],
                     [190.5, -19.5]]
    got = heatmap.generate_target_batch(T(joints), 64, 3.0, 2.0).numpy()
    want = np.asarray(jax_targets(jnp.asarray(joints), heatmap_size=64,
                                  stride=3.0, sigma=2.0))
    pallas = np.asarray(generate_target_batch_pallas(
        jnp.asarray(joints), heatmap_size=64, stride=3.0, sigma=2.0,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)
    packed = heatmap.pack_centers(T(joints), 64, 3.0, 2.0)
    assert packed[0, 0, 0] == 80 and packed[0, 1, 1] == 80


def test_heatmap_wrapper_on_cpu_is_the_plain_twin():
    joints = T(np.random.default_rng(3).uniform(
        -40, 300, size=(2, 21, 3)).astype(np.float32))
    before = generate_target_batch_cuda.launches
    got = generate_target_batch_cuda(joints, 32, 4.0, 2.0)
    torch.testing.assert_close(
        got, heatmap.generate_target_batch(joints, 32, 4.0, 2.0),
        rtol=0, atol=0)
    assert generate_target_batch_cuda.launches == before


@pytest.mark.parametrize("bad", [np.zeros((2, 21), np.float32),
                                 np.zeros((2, 21, 1), np.float32),
                                 np.zeros((2, 21, 2), np.int32)])
def test_heatmap_wrapper_rejects_bad_input(bad):
    with pytest.raises((ValueError, TypeError)):
        generate_target_batch_cuda(T(bad))


# ------------------------------------------------------------ color ops


def _img(seed, shape=(24, 20, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("op,factor", [
    ("adjust_brightness", 1.37), ("adjust_brightness", 0.52),
    ("adjust_contrast", 1.41), ("adjust_contrast", 0.55),
    ("adjust_saturation", 1.45), ("adjust_saturation", 0.6),
    ("adjust_hue", 0.5), ("adjust_hue", -0.5), ("adjust_hue", 0.23),
    ("adjust_hue", -0.37),
])
def test_color_op_matches_jax(op, factor):
    img = _img(11)
    img[:3, :3] = 0.5  # gray pixels: zero spread, hue stays 0
    img[3, :3] = 0.0   # black pixels: maxc == 0
    want = np.asarray(getattr(jcolor, op)(jnp.asarray(img),
                                          jnp.float32(factor)))
    got = getattr(color, op)(T(img), torch.tensor(factor)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_color_ops_take_per_image_factors():
    imgs = np.stack([_img(1), _img(2)])
    f = np.array([0.7, 1.3], np.float32)
    for op in ("adjust_brightness", "adjust_contrast", "adjust_saturation",
               "adjust_hue"):
        got = getattr(color, op)(T(imgs), T(f - (op == "adjust_hue"))).numpy()
        for i in range(2):
            want = getattr(color, op)(T(imgs[i]),
                                      torch.tensor(f[i] - (op == "adjust_hue")))
            np.testing.assert_array_equal(got[i], want.numpy(), err_msg=op)


def test_normalize_matches_jax():
    img = _img(4)
    np.testing.assert_allclose(
        color.normalize_imagenet(T(img)).numpy(),
        np.asarray(jcolor.normalize_imagenet(jnp.asarray(img))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed,enable", [(0, 1.0), (1, 1.0), (2, 0.0)])
def test_color_jitter_matches_jax_with_its_draws(seed, enable):
    """JAX color_jitter draws from a key; the same draws, replayed here
    from that key, go to the port's color_jitter as arguments."""
    key = jax.random.PRNGKey(seed)
    k_order, kb, kc, ks, kh = jax.random.split(key, 5)
    factors = np.array([
        jax.random.uniform(kb, (), minval=0.5, maxval=1.5),
        jax.random.uniform(kc, (), minval=0.5, maxval=1.5),
        jax.random.uniform(ks, (), minval=0.5, maxval=1.5),
        jax.random.uniform(kh, (), minval=-0.5, maxval=0.5)], np.float32)
    order = np.array(jax.random.permutation(k_order, 4), np.int32)
    img = _img(20 + seed)
    want = np.asarray(jcolor.color_jitter(key, jnp.asarray(img),
                                          enable=enable))
    got = color.color_jitter(T(img), T(factors), T(order),
                             enable=torch.tensor(enable)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("enable", [1.0, 0.0])
def test_channel_pixel_noise_matches_jax(enable):
    key = jax.random.PRNGKey(4)
    pn = np.array(jax.random.uniform(key, (3,), minval=0.6, maxval=1.4))
    img = _img(5)
    want = np.asarray(jcolor.channel_pixel_noise(key, jnp.asarray(img),
                                                 enable=enable))
    got = color.channel_pixel_noise(T(img), T(pn),
                                    enable=torch.tensor(enable)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------- fused aug (K1) twin


def _jax_fused_kernel(params, packed, images_u8, hm, sigma=2.0):
    """The JAX ``_kernel`` in a pallas_call with fused_aug.py's BlockSpecs."""
    b, h, w, _ = images_u8.shape
    j = packed.shape[1]
    kernel = functools.partial(jfused._kernel, height=h, width=w,
                               num_joints=j, heatmap_size=hm, sigma=sigma)
    out_planar, hms = pl.pallas_call(
        kernel,
        grid=(b,),
        in_specs=[
            pl.BlockSpec((1, 1, 12), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, j, 3), lambda i: (i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((1, 3, h, w), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=(
            pl.BlockSpec((1, 3, h, w), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, j, hm, hm), lambda i: (i, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((b, 3, h, w), jnp.bfloat16),
            jax.ShapeDtypeStruct((b, j, hm, hm), jnp.float32),
        ),
        interpret=True,
    )(jnp.asarray(params)[:, None, :], jnp.asarray(packed),
      jnp.transpose(jnp.asarray(images_u8), (0, 3, 1, 2)))
    return (np.asarray(jnp.transpose(out_planar, (0, 2, 3, 1))
                       .astype(jnp.float32)), np.asarray(hms))


def _bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# Between the two cases every op sits in every slot, including hue right
# before contrast; the enable and noise gates are on and off.
_ORDER_CASES = {
    "orders_a": ([[0, 1, 2, 3], [3, 1, 0, 2], [1, 2, 3, 0], [2, 3, 1, 0]],
                 [1, 1, 1, 0], [1, 0, 1, 1]),
    "orders_b": ([[3, 2, 1, 0], [1, 0, 3, 2], [0, 3, 2, 1], [2, 0, 1, 3]],
                 [1, 0, 1, 1], [0, 1, 1, 0]),
    # indices outside [0, 3]: lax.switch clamps -1 to brightness and 5 to
    # hue; clamping can put contrast in two slots (two image means)
    "clamped_a": ([[-1, 5, 1, 2], [5, 1, -1, 1], [1, -1, 1, 5],
                   [2, 1, 5, -1]], [1, 1, 1, 1], [1, 0, 0, 1]),
    "clamped_b": ([[5, 5, 5, 1], [-1, -1, 2, 1], [1, 1, 1, 1],
                   [-1, 5, 0, 3]], [1, 1, 0, 1], [0, 1, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(_ORDER_CASES))
def test_fused_aug_plain_matches_jax_kernel(case):
    order, enable, noise = _ORDER_CASES[case]
    rng = np.random.default_rng(len(case) + ord(case[-1]))
    b, s, hm = 4, 32, 8
    images = rng.integers(0, 256, size=(b, s, s, 3), dtype=np.uint8)
    joints = rng.uniform(-10, s + 10, size=(b, 21, 2)).astype(np.float32)
    factors = np.concatenate([rng.uniform(0.5, 1.5, (b, 3)),
                              rng.uniform(-0.5, 0.5, (b, 1))], axis=1)
    pn = rng.uniform(0.6, 1.4, (b, 3))
    pn = pn * np.array(noise)[:, None] + (1 - np.array(noise)[:, None])
    params = np.concatenate([np.array(enable)[:, None], factors,
                             np.array(order), pn], axis=1).astype(np.float32)
    packed = heatmap.pack_centers(T(joints), hm, 4.0, 2.0).numpy()

    want_img, want_hm = _jax_fused_kernel(params, packed, images, hm)
    got_img, got_hm = fused_aug_targets_plain(T(images), T(joints), T(params),
                                              heatmap_size=hm)
    assert got_img.dtype == torch.bfloat16 and got_img.shape == (b, s, s, 3)
    got_img = got_img.float().numpy()
    np.testing.assert_allclose(got_hm.numpy(), want_hm, rtol=0, atol=1e-5)
    err = np.abs(got_img - want_img)
    assert (err <= _bf16_ulp(want_img)).all(), err.max()
    assert (err == 0).mean() >= 0.999, (err == 0).mean()


def test_fused_aug_plain_disabled_is_normalize():
    """aug and noise off -> exactly normalize(u8 / 255) and plain targets."""
    rng = np.random.default_rng(8)
    images = T(rng.integers(0, 256, size=(3, 16, 16, 3), dtype=np.uint8))
    joints = T(rng.uniform(0, 16, size=(3, 21, 2)).astype(np.float32))
    params = draw_aug_params(torch.Generator().manual_seed(0),
                             torch.zeros(3), torch.zeros(3))
    got, tgt = fused_aug_targets_plain(images, joints, params, heatmap_size=4,
                                       out_dtype=torch.float32)
    want = color.normalize_imagenet(images.float() / 255.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(
        tgt, heatmap.generate_target_batch(joints, 4), rtol=0, atol=0)


def test_fused_aug_wrapper_on_cpu_is_the_plain_twin():
    rng = np.random.default_rng(9)
    images = T(rng.integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8))
    joints = T(rng.uniform(0, 16, size=(2, 21, 2)).astype(np.float32))
    params = draw_aug_params(torch.Generator().manual_seed(1),
                             torch.ones(2), torch.ones(2))
    before = fused_aug_targets_cuda.launches
    got = fused_aug_targets_cuda(images, joints, params, heatmap_size=4)
    want = fused_aug_targets_plain(images, joints, params, heatmap_size=4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fused_aug_targets_cuda.launches == before


@pytest.mark.parametrize("what", ["image_dtype", "image_channels",
                                  "params_shape", "params_dtype",
                                  "out_dtype", "device"])
def test_fused_aug_wrapper_rejects_bad_input(what):
    images = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    joints = torch.zeros((2, 21, 2))
    params = torch.zeros((2, 12))
    kw = {}
    if what == "image_dtype":
        images = images.float()
    elif what == "image_channels":
        images = torch.zeros((2, 8, 8, 4), dtype=torch.uint8)
    elif what == "params_shape":
        params = torch.zeros((2, 11))
    elif what == "params_dtype":
        params = params.double()
    elif what == "out_dtype":
        kw["out_dtype"] = torch.float16
    else:  # neither CPU nor CUDA: no silent fallback
        images, joints, params = (t.to("meta") for t in (images, joints,
                                                         params))
    with pytest.raises(ValueError):
        fused_aug_targets_cuda(images, joints, params, **kw)


def test_draw_aug_params_ranges_and_permutations():
    b = 512
    aug = (torch.arange(b) % 2).float()
    noise = (torch.arange(b) % 4 == 0).float()
    p = draw_aug_params(torch.Generator().manual_seed(0), aug, noise)
    assert p.shape == (b, 12) and p.dtype == torch.float32
    torch.testing.assert_close(p[:, 0], aug)
    assert ((p[:, 1:4] >= 0.5) & (p[:, 1:4] < 1.5)).all()
    assert ((p[:, 4] >= -0.5) & (p[:, 4] < 0.5)).all()
    assert (p[:, 4] < 0).any() and (p[:, 4] > 0).any()
    order = p[:, 5:9]
    assert (order.sort(dim=1).values == torch.arange(4.0)).all()
    assert len({tuple(r) for r in order.tolist()}) == 24  # all permutations
    on = noise.bool()
    assert ((p[on, 9:] >= 0.6) & (p[on, 9:] < 1.4)).all()
    assert (p[~on, 9:] == 1.0).all()
    again = draw_aug_params(torch.Generator().manual_seed(0), aug, noise)
    torch.testing.assert_close(p, again, rtol=0, atol=0)
    assert (draw_aug_params(torch.Generator().manual_seed(0), aug)[:, 9:]
            == 1.0).all()


# ---------------------------------------------------------- build setup


def test_nvcc_command_targets_sm90a_without_fast_math(tmp_path):
    cmd = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "fast_math" not in cmd and "--fmad=false" in cmd
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and name in path.name
        assert path == _build.library_path(name)  # keyed by content


# ------------------------------------------------------- decode / metrics


def test_get_max_preds_ties_and_nonpositive_match_jax():
    rng = np.random.default_rng(2)
    hm = rng.normal(size=(3, 5, 8, 8)).astype(np.float32)
    hm[0, 0] = 0.0
    hm[0, 0, 2, 5] = hm[0, 0, 6, 1] = 3.0  # tie: first index wins
    hm[1, 2] = -np.abs(hm[1, 2])           # max <= 0 -> preds zeroed
    hm[2, 4] = 0.0                         # all zero -> zeroed
    got_p, got_v = decode.get_max_preds(T(hm))
    want_p, want_v = jdecode.get_max_preds(jnp.asarray(hm))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_p[0, 0].numpy(), [5.0, 2.0])
    assert (got_p[1, 2] == 0).all() and (got_p[2, 4] == 0).all()


def _pred_gt(seed, cols=2):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 256, size=(6, 21, cols)).astype(np.float32)
    if cols == 3:
        gt[..., 2] = rng.integers(0, 2, size=(6, 21))
    pred = (gt[..., :2] + rng.normal(0, 20, size=(6, 21, 2))).astype(
        np.float32)
    w = np.array([1, 1, 0, 1, 0, 1], np.float32)
    return pred, gt, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fn,cols", [("pck_2d_counts", 2),
                                     ("epe_train", 2),
                                     ("epe_visible", 3)])
def test_metric_counts_match_jax(fn, cols, weighted):
    pred, gt, w = _pred_gt(hash(fn) % 100, cols)
    kw_t, kw_j = {}, {}
    if weighted:
        kw_t["sample_weight"], kw_j["sample_weight"] = T(w), jnp.asarray(w)
    if fn == "pck_2d_counts":
        kw_t["t"] = kw_j["t"] = 0.2
    got = getattr(metrics, fn)(T(pred), T(gt), **kw_t)
    want = getattr(jmetrics, fn)(jnp.asarray(pred), jnp.asarray(gt), **kw_j)
    for g, x in zip(got, want):
        np.testing.assert_allclose(float(g), float(x), rtol=1e-5)


def test_pck_mm_and_bad_threshold():
    pred, gt, _ = _pred_gt(3)
    got = metrics.pck_2d_counts(T(pred), T(gt), t=10.0, threshold="mm")
    want = jmetrics.pck_2d_counts(jnp.asarray(pred), jnp.asarray(gt), t=10.0,
                                  threshold="mm")
    assert [float(x) for x in got] == [float(x) for x in want]
    with pytest.raises(ValueError):
        metrics.pck_2d_counts(T(pred), T(gt), threshold="px")


def test_mse_loss_and_bbox_diagonal_match_jax():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(2, 21, 8, 8)).astype(np.float32)
    b = rng.normal(size=(2, 21, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.joints_mse_loss(T(a), T(b))),
        float(jmetrics.joints_mse_loss(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    gt = rng.uniform(0, 256, size=(4, 21, 3)).astype(np.float32)
    np.testing.assert_allclose(metrics.bbox_diagonal(T(gt)).numpy(),
                               np.asarray(jmetrics.bbox_diagonal(
                                   jnp.asarray(gt))), rtol=1e-6)
