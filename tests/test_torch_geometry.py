"""The port's leftover geometry (``ops/geometry.py``), Procrustes
alignment (``ops/procrustes.py``) and ``data/pipeline.py:IterationLoader``
against the JAX package's, on the CPU, with numpy inputs from a seed.

Tolerances: every geometry function within rtol 1e-5 (measured: 0 for all
but ``rodrigues``, 8.6e-7, whose norm is a sum of squares in each
package's order). Procrustes within atol 1e-4 on aligned points of unit
scale and on PA-MPJPE (measured 2.2e-5 and 5.9e-7): both packages take
the SVD of a 3x3 (2x2) matrix from a library (LAPACK through torch,
XLA's through JAX) whose f32 factors differ by ulps; a pair of singular
vectors that flips sign together leaves the rotation ``v z u^T`` as it
was, so the aligned points agree whatever signs each library picks.
``chip_smoke.py`` phase 9f holds the card's results to the CPU's within
the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixtures
from lighthand_tpu.data.pipeline import IterationLoader as JaxIterationLoader
from lighthand_tpu.data.pipeline import Loader as JaxLoader
from lighthand_tpu.data.synthetic import SyntheticHands as JaxHands
from lighthand_tpu.ops import geometry as jg
from lighthand_tpu.ops import procrustes as jp
from lighthand_tpu_torch.data import Loader, SyntheticHands
from lighthand_tpu_torch.data.pipeline import IterationLoader
from lighthand_tpu_torch.ops import geometry as tg
from lighthand_tpu_torch.ops import procrustes as tp

RTOL = torch_fixtures.GEOMETRY_RTOL
PROCRUSTES_ATOL = torch_fixtures.PROCRUSTES_ATOL
T = torch.from_numpy


def _cam(rng, n=21):
    cam = rng.normal(size=(n, 3)).astype(np.float32)
    cam[:, 2] += 5.0
    return cam


def _close(got, want, rtol=RTOL, atol=torch_fixtures.GEOMETRY_ATOL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(3))
def test_camera_transforms_match_jax(seed):
    rng = np.random.default_rng(seed)
    cam = _cam(rng)
    f = tuple(rng.uniform(300, 700, 2).tolist())
    c = tuple(rng.uniform(80, 140, 2).tolist())
    _close(tg.cam2pixel(T(cam), f, c), jg.cam2pixel(cam, f, c))
    _close(tg.pixel2cam(T(cam), f, c), jg.pixel2cam(cam, f, c))
    r = rng.normal(size=(3, 3)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    _close(tg.world2cam(T(cam.T.copy()), T(r), T(t)),
           jg.world2cam(cam.T, r, t))


@pytest.mark.parametrize("seed", range(3))
def test_rotations_match_jax(seed):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(8, 3)).astype(np.float32)
    theta[0] = 0.0  # the 1e-8 guard
    _close(tg.rodrigues(T(theta)), jg.rodrigues(theta))
    quat = rng.normal(size=(8, 4)).astype(np.float32)
    quat[1] = 0.0  # the 1e-8 floor of the norm
    _close(tg.quat2mat(T(quat)), jg.quat2mat(quat))
    euler = rng.uniform(-180, 180, 3).astype(np.float32)
    _close(tg.euler_to_rotation(T(euler)), jg.euler_to_rotation(euler))


@pytest.mark.parametrize("seed", range(3))
def test_projections_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 21, 3)).astype(np.float32)
    cam = rng.normal(size=(4, 3)).astype(np.float32)
    _close(tg.orthographic_projection(T(x), T(cam)),
           jg.orthographic_projection(jnp.asarray(x), jnp.asarray(cam)))
    pts = _cam(rng)
    euler = rng.uniform(-30, 30, 3).astype(np.float32)
    t = (rng.normal(size=3) + [0, 0, -10]).astype(np.float32)
    _close(tg.camera_calibration(T(pts), euler, t, 500.0, (112.0, 112.0)),
           jg.camera_calibration(pts, euler, t, 500.0, (112.0, 112.0)))


def _pairs(rng, b, d):
    s1 = rng.normal(size=(b, 21, d)).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    s2 = s1 @ q * 1.3 + rng.normal(size=(b, 21, d)).astype(np.float32) * 0.1
    return s1, s2.astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("seed", range(3))
def test_procrustes_matches_jax(seed, d):
    rng = np.random.default_rng(seed)
    s1, s2 = _pairs(rng, 6, d)
    _close(tp.compute_similarity_transform(T(s1[0]), T(s2[0])),
           jp.compute_similarity_transform(jnp.asarray(s1[0]),
                                           jnp.asarray(s2[0])),
           rtol=0, atol=PROCRUSTES_ATOL)
    for reduction in ("mean", "sum", "none"):
        _close(tp.reconstruction_error(T(s1), T(s2), reduction),
               jp.reconstruction_error(jnp.asarray(s1), jnp.asarray(s2),
                                       reduction),
               rtol=0, atol=PROCRUSTES_ATOL)


def test_procrustes_recovers_a_similarity_and_a_reflection():
    """An exact similarity aligns to 0 error; a reflected copy is aligned
    by a rotation (the det sign flip), as in JAX."""
    rng = np.random.default_rng(7)
    s1 = rng.normal(size=(2, 21, 3)).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    q *= np.sign(np.linalg.det(q))
    s2 = np.stack([s1[0] @ q.astype(np.float32) * 2 + 1,
                   s1[1] * [1, 1, -1]]).astype(np.float32)
    got = tp.reconstruction_error(T(s1), T(s2), "none")
    want = jp.reconstruction_error(jnp.asarray(s1), jnp.asarray(s2), "none")
    assert float(got[0]) < 1e-5
    _close(got, want, rtol=0, atol=PROCRUSTES_ATOL)


def test_iteration_loader_cycles():
    """tests/test_pipeline_extra.py's case: 2 batches an epoch, 7
    iterations over 4 reshuffled epochs, the same rows as JAX's."""
    base = Loader(SyntheticHands(length=16, size=32), batch_size=8,
                  device="cpu", shuffle=True, num_workers=1)
    epochs = []
    real = base.set_epoch
    base.set_epoch = lambda e: (epochs.append(e), real(e))
    seen = list(IterationLoader(base, num_iterations=7))
    assert [i for i, _ in seen] == list(range(7))
    assert epochs == [0, 1, 2, 3]
    assert all(tuple(b["image_u8"].shape) == (8, 32, 32, 3)
               for _, b in seen)
    jbase = JaxLoader(JaxHands(length=16, size=32), batch_size=8,
                      shuffle=True, num_workers=1)
    want = list(JaxIterationLoader(jbase, num_iterations=7))
    for (_, b), (_, jb) in zip(seen, want):
        np.testing.assert_array_equal(b["joints"].numpy(),
                                      np.asarray(jb["joints"]))


def test_iteration_loader_resume():
    base = Loader(SyntheticHands(length=16, size=32), batch_size=8,
                  device="cpu", shuffle=False, num_workers=1)
    itl = IterationLoader(base, num_iterations=5, start_iteration=3)
    assert len(itl) == 2
    assert [i for i, _ in itl] == [3, 4]
