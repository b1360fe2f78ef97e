"""The port's library metrics, soft-argmax decode, single-sample targets,
batch ColorJitter and ``DevicePreprocessor`` against the JAX package on the
same seeded numpy inputs (CPU).

Tolerances:

- PCK values (fractions, or % for ``pck_curve``) within 1e-6 (1e-4 %):
  both packages compute the same f32 distances, and one joint flipping
  across a threshold would move a fraction by 1/168 or more;
- losses within rtol 1e-6 (a mean sums in another order);
- soft-argmax within 1e-5 px (a softmax and two weighted sums in f32 over
  at most 256 cells), its confidence exactly;
- targets within 1e-5 (tests/test_pallas.py:16), their weights exactly;
- jittered images within 1e-5 in [0, 1], 5e-5 once normalised (ImageNet's
  std divides by as little as 0.224): the f32 color ops of
  tests/test_torch_ops.py.

torch cannot replay JAX's RNG, so the jitter is compared with JAX's draws
injected: ``jax.random.split`` per sample, then JAX's five-way split
(``lighthand_tpu/ops/color.py:108-123``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.data.pipeline import DevicePreprocessor as JaxPreprocessor
from lighthand_tpu.ops import color as jcolor
from lighthand_tpu.ops import decode as jdecode
from lighthand_tpu.ops import heatmap as jheatmap
from lighthand_tpu.ops import metrics as jmetrics
from lighthand_tpu_torch.data import DevicePreprocessor, preprocess_u8
from lighthand_tpu_torch.ops import color, decode, heatmap, metrics
from lighthand_tpu_torch.ops.kernels import heatmap as kheatmap
from lighthand_tpu_torch.ops.kernels.fused_aug import draw_aug_params
from tests.golden import golden_pck_2d, golden_pck_2d_visible

T = torch.from_numpy
PCK_ATOL, LOSS_RTOL, SOFT_ATOL, TARGET_ATOL = 1e-6, 1e-6, 1e-5, 1e-5
IMG_ATOL, NORM_ATOL = 1e-5, 5e-5


def _batch(seed, b=8, j=21, scale=8.0):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(10, 246, size=(b, j, 2)).astype(np.float32)
    pred = gt + rng.normal(scale=scale, size=(b, j, 2)).astype(np.float32)
    vis = (rng.uniform(size=(b, j)) > 0.25).astype(np.float32)
    return pred, gt, np.concatenate([gt, vis[..., None]], axis=-1)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("threshold,t", [("proportion", 0.05),
                                         ("proportion", 0.2),
                                         ("proportion", 0.5), ("mm", 5.0),
                                         ("mm", 15.0)])
def test_pck_2d_matches_jax_and_golden(threshold, t):
    pred, gt, _ = _batch(0)
    got = float(metrics.pck_2d(T(pred), T(gt), t, threshold))
    want = float(jmetrics.pck_2d(jnp.asarray(pred), jnp.asarray(gt), t,
                                 threshold))
    assert abs(got - want) <= PCK_ATOL
    assert abs(got - golden_pck_2d(pred, gt, t, threshold)) <= PCK_ATOL


def test_pck_2d_counts_a_distance_equal_to_t():
    """``<= t``: a joint exactly at the threshold is correct."""
    gt = np.zeros((1, 2, 2), np.float32)
    gt[0, 1] = [3.0, 4.0]  # diagonal 5
    pred = gt.copy()
    pred[0, 0, 0] = 1.0  # distance 1 = 0.2 of the diagonal
    assert float(metrics.pck_2d(T(pred), T(gt), 0.2)) == 1.0
    assert float(metrics.pck_2d(T(pred), T(gt), 0.19)) == 0.5


def test_pck_raises_on_an_unknown_threshold():
    pred, gt, gt_v = _batch(1)
    for fn, args in ((metrics.pck_2d, (T(pred), T(gt), 0.1)),
                     (metrics.pck_2d_visible, (T(pred), T(gt_v), 0.1)),
                     (metrics.pck_curve, (T(pred), T(gt), torch.ones(2)))):
        with pytest.raises(ValueError, match="proportion|mm"):
            fn(*args, threshold="pckh")


@pytest.mark.parametrize("threshold,t", [("proportion", 0.1),
                                         ("proportion", 0.3), ("mm", 5.0)])
def test_pck_2d_visible_matches_jax_and_golden(threshold, t):
    pred, _, gt_v = _batch(2)
    got = float(metrics.pck_2d_visible(T(pred), T(gt_v), t, threshold))
    want = float(jmetrics.pck_2d_visible(jnp.asarray(pred),
                                         jnp.asarray(gt_v), t, threshold))
    assert abs(got - want) <= PCK_ATOL
    assert abs(got - golden_pck_2d_visible(pred, gt_v, t, threshold)) \
        <= 1e-5  # the golden's eps is f64's, JAX's and the port's f32 tiny


def test_pck_2d_visible_semantics():
    """The diagonal over every GT joint (the wrist included), joints 1:
    scored, invisible ones out of the denominator; all invisible gives 0."""
    pred, _, gt_v = _batch(3, b=2)
    far = gt_v.copy()
    far[:, 0, :2] += 500.0  # the wrist: unscored, but widens the diagonal
    got = float(metrics.pck_2d_visible(T(pred), T(far), 0.05))
    want = float(jmetrics.pck_2d_visible(jnp.asarray(pred),
                                         jnp.asarray(far), 0.05))
    assert got == pytest.approx(want, abs=PCK_ATOL) and got == 1.0
    hidden = gt_v.copy()
    hidden[..., 2] = 0.0
    assert float(metrics.pck_2d_visible(T(pred), T(hidden))) == 0.0
    assert float(jmetrics.pck_2d_visible(jnp.asarray(pred),
                                         jnp.asarray(hidden))) == 0.0


@pytest.mark.parametrize("threshold,grid", [
    ("proportion", np.linspace(0.1, 0.3, 100)),
    ("mm", np.linspace(0, 30, 101)[1:] * jmetrics.MM_THRESH_SCALE_EVAL)])
def test_pck_curve_matches_jax(threshold, grid):
    pred, gt, _ = _batch(4, scale=60.0)
    grid = grid.astype(np.float32)
    got = metrics.pck_curve(T(pred), T(gt), T(grid), threshold).numpy()
    want = np.asarray(jmetrics.pck_curve(jnp.asarray(pred), jnp.asarray(gt),
                                         jnp.asarray(grid), threshold))
    assert got.shape == (len(grid),) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=100 * PCK_ATOL)
    assert got[0] < got[-1] <= 100.0


def test_pck_3d_and_keypoint_3d_loss_match_jax():
    rng = np.random.default_rng(5)
    gt = rng.uniform(-50, 50, size=(6, 21, 3)).astype(np.float32)
    pred = gt + rng.normal(scale=3.0, size=gt.shape).astype(np.float32)
    assert metrics.PX_TO_MM_PCK3D == jmetrics.PX_TO_MM_PCK3D == 3.779527559
    for t in (5.0, 12.0, 20.0):
        got, t_out = metrics.pck_3d(T(pred), T(gt), t)
        want, _ = jmetrics.pck_3d(jnp.asarray(pred), jnp.asarray(gt), t)
        assert t_out == t and abs(float(got) - float(want)) <= PCK_ATOL
    got = float(metrics.keypoint_3d_loss(T(pred), T(gt)))
    want = float(jmetrics.keypoint_3d_loss(jnp.asarray(pred),
                                           jnp.asarray(gt)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="gt_3d_keypoint No"):
        metrics.keypoint_3d_loss(torch.zeros(0, 21, 3), torch.zeros(0, 21, 3))


@pytest.mark.parametrize("vis", [False, True])
def test_keypoint_2d_loss_matches_jax(vis):
    pred, gt, gt_v = _batch(6)
    target = gt_v if vis else gt
    if vis:
        pred[0, 3] = gt[0, 3]  # an exact joint: not a positive element
    got = float(metrics.keypoint_2d_loss(T(pred), T(target)))
    want = float(jmetrics.keypoint_2d_loss(jnp.asarray(pred),
                                           jnp.asarray(target)))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    if vis:  # the mean over the strictly positive masked elements only
        err = (pred - gt) ** 2 * gt_v[..., 2:]
        assert got == pytest.approx(err[err > 0].mean(), rel=1e-5)


def test_keypoint_2d_loss_all_masked_is_zero():
    _, gt, gt_v = _batch(7, b=2)
    gt_v[..., 2] = 0.0
    assert float(metrics.keypoint_2d_loss(T(gt + 1.0), T(gt_v))) == 0.0


# ----------------------------------------------------------------- decode


@pytest.mark.parametrize("temperature", [1.0, 20.0])
def test_soft_argmax_matches_jax(temperature):
    hm = np.random.default_rng(8).normal(size=(3, 21, 16, 16)) \
        .astype(np.float32)
    got_p, got_c = decode.soft_argmax_preds(T(hm), temperature)
    want_p, want_c = jdecode.soft_argmax_preds(jnp.asarray(hm), temperature)
    assert got_p.shape == (3, 21, 2) and got_c.shape == (3, 21, 1)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=SOFT_ATOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_soft_argmax_bf16_maps_decode_in_f32():
    hm = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    b16 = hm.bfloat16()
    got_p, got_c = decode.soft_argmax_preds(b16)
    want_p, want_c = jdecode.soft_argmax_preds(
        jnp.asarray(b16.float().numpy()).astype(jnp.bfloat16))
    assert got_p.dtype == torch.float32
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=SOFT_ATOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_soft_argmax_gradcheck():
    hm = torch.randn(2, 3, 8, 8, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1),
                     requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x: decode.soft_argmax_preds(x, 2.0)[0], (hm,))


def test_soft_argmax_close_to_hard_on_peaked_maps():
    joints = np.random.default_rng(9).uniform(32, 224, size=(2, 21, 2)) \
        .astype(np.float32)
    hm = heatmap.generate_target_batch(T(joints))
    hard, _ = decode.get_max_preds(hm)
    soft, _ = decode.soft_argmax_preds(hm, temperature=20.0)
    assert float((soft - hard).abs().max()) < 1.0


# -------------------------------------------------------- one-sample targets


def _trap_joints(seed, cols=2):
    """Joints on, near and off the map, with the truncation trap: x = -3
    gives mu 0 (int() truncates), where a floor would give -1."""
    rng = np.random.default_rng(seed)
    joints = rng.uniform(-40, 300, size=(21, cols)).astype(np.float32)
    joints[:5, :2] = [[-3.0, -1.9], [-26.5, 10.0], [255.0, 300.0],
                      [400.0, 5.0], [-60.0, -60.0]]
    return joints


@pytest.mark.parametrize("hm,stride,cols", [(64, 4.0, 2), (50, 3.0, 3)])
def test_generate_target_matches_jax(hm, stride, cols):
    joints = _trap_joints(10 + cols, cols)
    kw = {"heatmap_size": hm, "stride": stride, "sigma": 2.0}
    got = heatmap.generate_target(T(joints), **kw)
    got_t, got_w = heatmap.generate_target(T(joints), return_weight=True,
                                           **kw)
    want_t, want_w = jheatmap.generate_target(jnp.asarray(joints),
                                              return_weight=True, **kw)
    assert got.shape == (21, hm, hm) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_t), rtol=0,
                               atol=TARGET_ATOL)
    assert torch.equal(got, got_t)
    assert got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert 0.0 < float(got_w.mean()) < 1.0  # joints on and off the map
    # the maps of dropped joints are zero; their weights come from the same
    # centers
    assert float(got[got_w == 0].abs().max()) == 0.0


def test_generate_target_goes_through_k2s_wrapper(monkeypatch):
    """On the CPU the K2 wrapper computes its twin; ``generate_target``
    calls it with B=1 (on a CUDA tensor the same call launches K2)."""
    calls = []
    wrapper = kheatmap.generate_target_batch_cuda

    def spy(joints, *args):
        calls.append(tuple(joints.shape))
        return wrapper(joints, *args)

    monkeypatch.setattr(kheatmap, "generate_target_batch_cuda", spy)
    joints = _trap_joints(12)
    got = heatmap.generate_target(T(joints))
    assert calls == [(1, 21, 2)]
    assert torch.equal(got, heatmap.generate_target_batch(T(joints)[None])[0])
    int_joints = np.round(joints).astype(np.int64)  # cast to f32 first
    np.testing.assert_allclose(
        heatmap.generate_target(T(int_joints)).numpy(),
        np.asarray(jheatmap.generate_target(int_joints)), atol=TARGET_ATOL)


# ------------------------------------------------------------------ jitter

RANGES = {"brightness": 0.3, "contrast": 0.8, "saturation": 1.2, "hue": 0.1}


def _jax_jitter_draws(key, b, brightness=0.5, contrast=0.5, saturation=0.5,
                      hue=0.5):
    """JAX's per-sample draws (``color_jitter_batch`` splits the key per
    sample, ``color_jitter`` five ways) as the port's factors and order."""
    factors = np.zeros((b, 4), np.float32)
    order = np.zeros((b, 4), np.int64)
    for i, k in enumerate(jax.random.split(key, b)):
        k_order, kb, kc, ks, kh = jax.random.split(k, 5)
        factors[i] = [
            jax.random.uniform(kk, (), minval=lo, maxval=hi)
            for kk, lo, hi in (
                (kb, max(0.0, 1 - brightness), 1 + brightness),
                (kc, max(0.0, 1 - contrast), 1 + contrast),
                (ks, max(0.0, 1 - saturation), 1 + saturation),
                (kh, -hue, hue))]
        order[i] = np.asarray(jax.random.permutation(k_order, 4))
    return T(factors), T(order)


def _u8(seed, b=6, h=12, w=10):
    return np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("ranges", [{}, RANGES], ids=["default", "custom"])
def test_color_jitter_batch_matches_jax_with_its_draws(ranges):
    b = 24
    imgs = _u8(20, b=b).astype(np.float32) / np.float32(255.0)
    enable = (np.arange(b) % 4 != 1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jcolor.color_jitter_batch(
        key, jnp.asarray(imgs), jnp.asarray(enable), **ranges))
    factors, order = _jax_jitter_draws(key, b, **ranges)
    # JAX's draws put every op in every slot among the jittered samples
    jittered = order[enable == 1]
    assert all((jittered[:, slot] == op).any() for slot in range(4)
               for op in range(4))
    got = color.color_jitter_batch(T(imgs), T(enable), factors=factors,
                                   order=order, **ranges)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)
    np.testing.assert_array_equal(got.numpy()[enable == 0],
                                  imgs[enable == 0])


def test_draw_jitter_ranges_and_order():
    factors, order = color.draw_jitter(torch.Generator().manual_seed(0), 4000,
                                       **RANGES)
    lo = torch.tensor([0.7, 0.2, 0.0, -0.1])
    hi = torch.tensor([1.3, 1.8, 2.2, 0.1])
    assert ((factors >= lo) & (factors < hi)).all()
    # the draws fill their ranges
    assert ((factors.amin(0) - lo).abs() < 2e-3 * (hi - lo)).all()
    assert ((factors.amax(0) - hi).abs() < 2e-3 * (hi - lo)).all()
    assert torch.equal(order.sort(dim=1).values,
                       torch.arange(4).expand(4000, 4))
    imgs, enable = torch.rand(5, 4, 4, 3), torch.tensor([1.0, 0, 1, 1, 1])
    got = color.color_jitter_batch(imgs, enable, generator=torch.Generator()
                                   .manual_seed(1), **RANGES)
    factors, order = color.draw_jitter(torch.Generator().manual_seed(1), 5,
                                       **RANGES)
    assert torch.equal(got, color.color_jitter(imgs, factors, order, enable))
    with pytest.raises(ValueError, match="generator"):
        color.color_jitter_batch(torch.rand(2, 4, 4, 3), torch.ones(2))


def test_draw_aug_params_keeps_its_draws():
    """K1's packed draws are ``draw_jitter``'s at the default ranges, bit
    for bit what they were before it was factored out (the formula below),
    so the fused steps' and the chain's draws do not move."""
    aug = torch.arange(37) % 2
    noise = torch.arange(37) % 3 == 0
    for seed in range(4):
        got = draw_aug_params(torch.Generator().manual_seed(seed), aug, noise)
        gen = torch.Generator().manual_seed(seed)
        u = torch.rand((37, 4), generator=gen)
        factors = torch.cat([0.5 + u[:, :3], u[:, 3:] - 0.5], dim=1)
        order = torch.argsort(torch.rand((37, 4), generator=gen), dim=1)
        pn = 0.6 + 0.8 * torch.rand((37, 3), generator=gen)
        nz = noise.float()[:, None]
        want = torch.cat([aug.float()[:, None], factors, order.float(),
                          pn * nz + (1.0 - nz)], dim=1)
        assert torch.equal(got, want)


# ----------------------------------------------------- DevicePreprocessor


@pytest.mark.parametrize("jitter,ranges", [(False, {}), (True, {}),
                                           (True, RANGES)],
                         ids=["plain", "jitter", "jitter-custom"])
def test_device_preprocessor_matches_jax(jitter, ranges):
    images = _u8(21)
    aug = np.array([1, 1, 0, 1, 0, 1], np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JaxPreprocessor(jitter=jitter, out_dtype=jnp.float32,
                                      **ranges)(key, jnp.asarray(images),
                                                jnp.asarray(aug)))
    pre = DevicePreprocessor(jitter=jitter, out_dtype=torch.float32,
                             device="cpu", **ranges)
    factors, order = _jax_jitter_draws(key, 6, **ranges)
    got = pre(T(images), T(aug), factors=factors, order=order)
    assert got.dtype == torch.float32 and got.shape == (6, 12, 10, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NORM_ATOL)
    plain = preprocess_u8(T(images), torch.float32)
    off = [i for i in range(6) if not (jitter and aug[i])]
    assert torch.equal(got[off], plain[off])


def test_device_preprocessor_bf16_and_generator():
    images = T(_u8(22))
    aug = torch.tensor([1.0, 0, 1, 0, 1, 1])
    pre = DevicePreprocessor(device="cpu")
    assert pre.out_dtype == torch.bfloat16 and pre.jitter
    a = pre(images, aug, torch.Generator().manual_seed(4))
    b = pre(images, aug, torch.Generator().manual_seed(4))
    c = pre(images, aug, torch.Generator().manual_seed(5))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.equal(a[[1, 3]], preprocess_u8(images)[[1, 3]])
    factors, order = color.draw_jitter(torch.Generator().manual_seed(4), 6)
    assert torch.equal(a, pre(images, aug, factors=factors, order=order))
    assert torch.equal(DevicePreprocessor(jitter=False, device="cpu")(
        images, aug), preprocess_u8(images))


def test_device_preprocessor_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePreprocessor()
