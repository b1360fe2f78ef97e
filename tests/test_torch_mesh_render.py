"""The port's mesh renderer (``lighthand_tpu_torch/utils/mesh_render.py``)
and its rasterizer's plain twin (``ops/kernels/rasterize.py``) against the
JAX package's numpy renderer (``lighthand_tpu/utils/mesh_render.py``), on
the CPU.

Tolerance: none. Every function gives numpy's f64 values bit for bit (the
contract is 1e-12; the port keeps numpy's order of operations, so it is
exact), and the rendered image is equal, with equal coverage (rendered
over a NaN background, which the clip keeps: covered pixels are the finite
ones), on the cases of ``tests/test_vis_extra.py`` and on a seeded
ellipsoid of about 1.5k faces (MANO's size) with a patch of coplanar
duplicate faces whose vertices carry other colours. The rasterizer keeps,
at each pixel, the first face of the nearest depth, as the loop does. The
kernel (``csrc/rasterize.cu``) is held bit for bit to the twin on the card
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import procedural_hand_mesh
from lighthand_tpu.utils import mesh_render as jm
from lighthand_tpu_torch.ops.kernels.rasterize import (
    rasterize_mesh_cuda,
    rasterize_mesh_plain,
)
from lighthand_tpu_torch.utils import mesh_render as tm

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), want)
    assert np.abs(_np(got) - want).max(initial=0.0) <= 1e-12


def _square(z, size=1.0):
    """test_vis_extra.py's two triangles spanning [-size, size]^2 at z."""
    v = np.array([[-size, -size, z], [size, -size, z], [size, size, z],
                  [-size, size, z]])
    return v, np.array([[0, 2, 1], [0, 3, 2]])


@pytest.fixture(scope="module")
def mesh():
    """``chip_smoke.procedural_hand_mesh``: 1512 ellipsoid faces, then 60
    coplanar copies over copied vertices with other colours."""
    return procedural_hand_mesh()


def test_rotate_y_and_rodrigues_match_jax():
    pts = np.random.default_rng(0).normal(size=(50, 3))
    for angle in (np.pi / 2, np.radians(120), -0.3):
        _equal(tm.rotate_y(pts, angle, CPU), jm.rotate_y(pts, angle))
        _equal(tm.rotate_y(pts[3], angle, CPU), jm.rotate_y(pts[3], angle))
    for rvec in (np.zeros(3), np.array([1e-13, 0, 0]), [0.3, -0.2, 0.5],
                 np.random.default_rng(1).normal(size=3) * 2):
        _equal(tm.rodrigues_np(rvec, CPU), jm.rodrigues_np(rvec))


@pytest.mark.parametrize("rot", ["zero", "seeded"])
def test_project_points_matches_jax(mesh, rot):
    v = mesh[0]
    rt = (np.zeros(3) if rot == "zero"
          else np.random.default_rng(2).normal(size=3))
    t, f, c = np.array([0.01, -0.02, 2.0]), np.array([900.0, 700.0]), \
        np.array([400.0, 300.0])
    got = tm.project_points(v, rt, t, f, c, CPU)
    want = jm.project_points(v, rt, t, f, c)
    for g, w in zip(got, want):
        _equal(g, w)
    # the near-zero depth guard
    z0 = np.array([[1.0, 2.0, 0.0], [1.0, 2.0, 1e-12]])
    for g, w in zip(tm.project_points(z0, rt, np.zeros(3), 100.0, [0, 0],
                                      CPU),
                    jm.project_points(z0, rt, np.zeros(3), 100.0, [0, 0])):
        _equal(g, w)


def test_vertex_normals_and_lights_match_jax(mesh):
    v, f, _ = mesh
    _equal(tm.vertex_normals(v, f, CPU), jm.vertex_normals(v, f))
    # a fan: one vertex in 40 faces, and an unused vertex (zero normal)
    ang = np.linspace(0, 2 * np.pi, 41)[:-1]
    fan = np.concatenate([[[0, 0, 1.0]], np.stack(
        [np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)], 1), [[5, 5, 5]]])
    fan_f = np.array([[0, 1 + i, 1 + (i + 1) % 40] for i in range(40)])
    _equal(tm.vertex_normals(fan, fan_f, CPU), jm.vertex_normals(fan, fan_f))
    for light, albedo, color in (([-200, -100, -100.0], [0.65, 0.74, 0.86],
                                  [1, 1, 1.0]),
                                 ([0, 0, 1000.0], [1, 0.5, 0.25],
                                  [0.7, 0.7, 0.7])):
        _equal(tm.lambertian_point_light(v, f, light, albedo, color,
                                         device=CPU),
               jm.lambertian_point_light(v, f, np.array(light),
                                         np.array(albedo), np.array(color)))


def _coverage(img):
    return np.isfinite(_np(img)).all(-1)


def test_rasterize_near_face_wins_matches_jax():
    """test_vis_extra.py's occlusion case, over zeros and over NaN."""
    vr, fr = _square(5.0, size=1.0)
    vg, fg = _square(3.0, size=0.3)
    verts = np.concatenate([vr, vg])
    faces = np.concatenate([fr, fg + 4])
    colors = np.array([[1.0, 0, 0]] * 4 + [[0, 1.0, 0]] * 4)
    px, z = jm.project_points(verts, np.zeros(3), np.zeros(3),
                              np.array([40.0, 40.0]), np.array([32.0, 32.0]))
    for bg in (np.zeros((64, 64, 3)), np.full((64, 64, 3), np.nan)):
        got = tm.rasterize_mesh(px, z, faces, colors, bg, near=1.0,
                                device=CPU)
        want = jm.rasterize_mesh(px, z, faces, colors, background=bg,
                                 near=1.0)
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_coverage(got), _coverage(want))
    np.testing.assert_array_equal(_np(got)[32, 32], [0, 1.0, 0])


@pytest.mark.parametrize("route", ["render", "vertex_color"])
def test_renderer_cases_of_test_vis_extra_match_jax(route):
    v, f = _square(5.0)
    if route == "render":
        kw = dict(img=np.zeros((64, 64, 3)), use_bg=True, focal_length=40.0,
                  camera_t=np.zeros(3), camera_rot=np.zeros(3))
        got = tm.Renderer(faces=f, device=CPU).render(v, **kw)
        want = jm.Renderer(faces=f).render(v, **kw)
    else:
        kw = dict(faces=f, img=np.zeros((48, 48, 3)), use_bg=True,
                  focal_length=30.0, vertex_color=np.array([1.0, 0, 0]))
        got = tm.Renderer(device=CPU).render_vertex_color(v, **kw)
        want = jm.Renderer().render_vertex_color(v, **kw)
    np.testing.assert_array_equal(_np(got), want)
    assert got.dtype == torch.float64 and got.device.type == "cpu"


@pytest.mark.parametrize("size,focal,rot", [
    ((800, 600), 5000.0, "zero"), ((224, 224), 1500.0, "zero"),
    ((224, 224), 1500.0, "seeded")])
def test_renderer_on_seeded_mesh_matches_jax(mesh, size, focal, rot):
    v, f, colors = mesh
    w, h = size
    rt = (np.zeros(3) if rot == "zero"
          else np.random.default_rng(3).normal(size=3) * 0.5)
    kw = dict(camera_t=np.array([0.01, -0.02, 2.0]), camera_rot=rt,
              focal_length=focal)
    got = tm.Renderer(w, h, faces=f, device=CPU).render(v, **kw)
    want = jm.Renderer(w, h, faces=f).render(v, **kw)
    np.testing.assert_array_equal(_np(got), want)
    # the vertex-colour route over a NaN image: the same coverage
    nan = np.full((h, w, 3), np.nan)
    got = tm.Renderer(device=CPU).render_vertex_color(
        v, faces=f, img=nan, use_bg=True, vertex_color=colors, **kw)
    want = jm.Renderer().render_vertex_color(
        v, faces=f, img=nan, use_bg=True, vertex_color=colors, **kw)
    np.testing.assert_array_equal(_np(got), want)
    cover = _coverage(want)
    np.testing.assert_array_equal(_coverage(got), cover)
    assert 0 < cover.mean() < 1


def test_rasterizer_twin_keeps_the_loops_tie_rule(mesh):
    """Coplanar faces of equal depth: the first in index order keeps the
    pixel, whichever order the faces come in; a nearer later face takes
    it; the twin equals the JAX package's loop in every order."""

    def both(px, z, faces, colors, bg):
        got = rasterize_mesh_plain(*(torch.from_numpy(np.asarray(a)) for a
                                     in (px, z, faces, colors, bg)),
                                   near=1.0, far=10.0).numpy()
        want = jm.rasterize_mesh(px, z, faces, colors, bg, near=1.0,
                                 far=10.0)
        np.testing.assert_array_equal(got, want)
        return got

    # two identical squares at z = 5, red then green, and green then red
    v, f = _square(5.0)
    verts = np.concatenate([v, v])
    colors = np.array([[1.0, 0, 0]] * 4 + [[0, 1.0, 0]] * 4)
    px, z = jm.project_points(verts, np.zeros(3), np.zeros(3),
                              np.array([40.0, 40.0]), np.array([32.0, 32.0]))
    bg = np.full((64, 64, 3), np.nan)
    for faces, first in ((np.concatenate([f, f + 4]), [1.0, 0, 0]),
                         (np.concatenate([f + 4, f]), [0, 1.0, 0])):
        got = both(px, z, faces, colors, bg)
        covered = np.isfinite(got).all(-1)
        assert covered.sum() > 200
        np.testing.assert_allclose(got[covered], np.broadcast_to(
            first, got[covered].shape), atol=1e-12)
    # a later square nearer by 1e-9 takes every pixel the first one holds
    verts[4:, 2] -= 1e-9
    px, z = jm.project_points(verts, np.zeros(3), np.zeros(3),
                              np.array([40.0, 40.0]), np.array([32.0, 32.0]))
    got = both(px, z, np.concatenate([f, f + 4]), colors, bg)
    green = got[np.isfinite(got).all(-1)]
    np.testing.assert_allclose(green, np.broadcast_to([0, 1.0, 0],
                                                      green.shape), atol=1e-12)
    # the seeded mesh's coplanar copies: the orders give other images
    v, f, colors = mesh
    px, z = jm.project_points(v, np.zeros(3), np.array([0, 0, 2.0]),
                              np.array([1500.0, 1500.0]),
                              np.array([112.0, 112.0]))
    bg = np.full((224, 224, 3), np.nan)
    n = 1512  # the ellipsoid's own faces; the copies come after them
    a = both(px, z, f, colors, bg)
    b = both(px, z, np.concatenate([f[n:], f[:n]]), colors, bg)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    assert (a != b).any(-1).sum() > 100


@pytest.mark.parametrize("case", ["near_cull", "far_cull", "off_image",
                                  "degenerate", "empty"])
def test_rasterizer_culls_match_jax(case):
    """The whole-triangle near cull, the far cull and the far test per
    pixel, boxes off the image, zero-area faces, no faces."""
    rng = np.random.default_rng(4)
    px = rng.uniform(-10, 40, size=(9, 2))
    z = rng.uniform(1.5, 4.0, 9)
    faces = rng.integers(0, 9, size=(12, 3))
    far = np.inf
    if case == "near_cull":
        z[:3] = [0.5, 1.0, 2.0]
    elif case == "far_cull":
        far = 2.5
    elif case == "off_image":
        px[:5] += 200
    elif case == "degenerate":
        faces[:4, 2] = faces[:4, 1]
        px[7] = px[8]
    else:
        faces = faces[:0]
    colors = rng.uniform(-0.5, 1.5, size=(9, 3))  # the clip acts
    bg = rng.uniform(-0.2, 1.2, size=(30, 33, 3))
    got = rasterize_mesh_cuda(*(torch.from_numpy(np.ascontiguousarray(a))
                                for a in (px, z, faces, colors, bg)),
                              near=1.0, far=far)
    want = jm.rasterize_mesh(px, z, faces, colors, bg, near=1.0, far=far)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_the_cpu_is_the_twin_and_checks_its_inputs(mesh):
    v, f, colors = mesh
    px, z = jm.project_points(v, np.zeros(3), np.array([0, 0, 2.0]),
                              np.array([1500.0, 1500.0]),
                              np.array([112.0, 112.0]))
    args = [torch.from_numpy(a) for a in (px, z, f, colors,
                                          np.zeros((224, 224, 3)))]
    before = rasterize_mesh_cuda.launches
    got = rasterize_mesh_cuda(*args, near=1.0, far=10.0)
    assert rasterize_mesh_cuda.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, rasterize_mesh_plain(
        *args, near=1.0, far=10.0), rtol=0, atol=0)
    bad = [list(args) for _ in range(4)]
    bad[0][0] = args[0].float()
    bad[1][2] = args[2].double()
    bad[2][1] = args[1][:-1]
    bad[3][4] = args[4][..., :2]
    for a, exc in zip(bad, (TypeError, TypeError, ValueError, ValueError)):
        with pytest.raises(exc):
            rasterize_mesh_cuda(*a)


def test_entry_points_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the machine without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.Renderer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.vertex_normals(*_square(5.0))
