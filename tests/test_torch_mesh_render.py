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
duplicate faces whose vertices carry other colours, and on
``torch_fixtures.raster_edge_cases`` (more faces on one tile than the kernel's
list holds, a face larger than a tile, faces off the image, 1x1 and 17x13
images). The rasterizer keeps, at each pixel, the first face of the
nearest depth, as the loop does. The kernel (``csrc/rasterize.cu``) is
held bit for bit to the twin on the card by ``chip_smoke.py``; here its
walk is replayed in numpy at the wrapper's two geometries (``LARGE`` and
``SMALL``: tiles, threads a pixel, list capacity) and held to the loop:
lists filled in passes of a block's thread count and emptied where a pass
would overflow them, ordered nearest first, each pixel's threads stopping
at the first face whose depth bound is beyond their best.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_fixtures import procedural_hand_mesh, raster_edge_cases
from lighthand_tpu.utils import mesh_render as jm
from lighthand_tpu_torch.ops.kernels.rasterize import (
    LARGE,
    SMALL,
    choose_geometry,
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
    """``torch_fixtures.procedural_hand_mesh``: 1512 ellipsoid faces, then 60
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


# ------------------------------------------------ the kernel's tile walk

# (tile (W, H) pixels, threads a pixel, list capacity): the wrapper's two
GEOMETRIES = {"large": LARGE, "small": SMALL}


def _near_key(z):
    """``csrc/rasterize.cu:near_key`` of faces' depths [F, 3]."""
    zmin = np.fmin.reduce(z, axis=1)
    return np.where(np.isnan(zmin), np.inf, zmin)


def _beyond(key, best):
    """``csrc/rasterize.cu:beyond``."""
    return (key >= 2.0 ** -900) & (best < np.fmin(key * (1 - 2.0 ** -48),
                                                   1e12))


def _replay_tiles(px, z, faces, colors, bg, near, far, tile, sub, cap):
    """``csrc/rasterize.cu``'s walk in numpy: the setup's culls and boxes
    (all zero where a face is not drawn) and the boxes of groups of 32
    faces (the union of the drawn ones'); then for each tile the groups
    that meet it, in passes of the block's thread count, their faces in
    passes of a group a warp, those whose box meets the tile appended in
    index order to a list of ``cap`` that is walked and emptied where a
    pass would overflow it; each walk orders the list by (nearest depth,
    face), each of a pixel's ``sub`` threads keeps the least (depth, face)
    among its entries (every ``sub``-th) whose box holds the pixel,
    stopping at the first entry beyond its best, and the least of the
    threads wins; then the shade, with the loop's expressions. Returns
    (image, the most faces that met one tile, the lists walked)."""
    h, w = bg.shape[:2]
    tw, th = tile
    nt = tw * th * sub
    p, zf = px[faces], z[faces]
    keep = ~((zf <= near).any(1) | (zf >= far).all(1))
    x0 = np.maximum(np.floor(p[:, :, 0].min(1)), 0)
    x1 = np.minimum(np.ceil(p[:, :, 0].max(1)) + 1, w)
    y0 = np.maximum(np.floor(p[:, :, 1].min(1)), 0)
    y1 = np.minimum(np.ceil(p[:, :, 1].max(1)) + 1, h)
    denom = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    keep &= (x0 < x1) & (y0 < y1) & ~(np.abs(denom) < 1e-12)
    box = np.where(keep[:, None], np.stack([x0, x1, y0, y1], 1),
                   0).astype(np.int64)
    keys = _near_key(zf)
    groups = []
    for g in range(0, len(faces), 32):
        b, k = box[g:g + 32], keep[g:g + 32]
        groups.append([b[k, 0].min(), b[k, 1].max(), b[k, 2].min(),
                       b[k, 3].max()] if k.any() else [0, 0, 0, 0])
    color = np.array(bg, dtype=np.float64)
    most, walks = 0, 0
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            tx1, ty1 = min(tx0 + tw, w), min(ty0 + th, h)

            def meets(b):
                return (b[0] < b[1] and b[0] < tx1 and b[1] > tx0
                        and b[2] < ty1 and b[3] > ty0)

            ys, xs = np.mgrid[ty0:ty1, tx0:tx1]
            best = np.full((sub,) + xs.shape, np.inf)
            won = np.full((sub,) + xs.shape, -1)
            bw = np.zeros((sub,) + xs.shape + (3,))

            def walk(lst):
                live = np.ones((sub,) + xs.shape, bool)
                for i, f in enumerate(sorted(lst, key=lambda f: (keys[f],
                                                                 f))):
                    part = i % sub
                    live[part] &= ~_beyond(keys[f], best[part])
                    b = box[f]
                    inb = (live[part] & (xs >= b[0]) & (xs < b[1])
                           & (ys >= b[2]) & (ys < b[3]))
                    pf, xc, yc = p[f], xs + 0.5, ys + 0.5
                    w1 = ((xc - pf[0, 0]) * (pf[2, 1] - pf[0, 1])
                          - (pf[2, 0] - pf[0, 0]) * (yc - pf[0, 1])) / denom[f]
                    w2 = ((pf[1, 0] - pf[0, 0]) * (yc - pf[0, 1])
                          - (xc - pf[0, 0]) * (pf[1, 1] - pf[0, 1])) / denom[f]
                    w0 = 1.0 - w1 - w2
                    inv_z = w0 / zf[f, 0] + w1 / zf[f, 1] + w2 / zf[f, 2]
                    pix_z = 1.0 / np.maximum(inv_z, 1e-12)
                    win = (inb & (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                           & (pix_z < far)
                           & ((pix_z < best[part])
                              | ((pix_z == best[part]) & (f < won[part]))))
                    best[part][win], won[part][win] = pix_z[win], f
                    bw[part][win] = np.stack([w0, w1, w2], -1)[win]

            lst, met = [], 0
            for g0 in range(0, len(groups), nt):
                hits = [g for g in range(g0, min(g0 + nt, len(groups)))
                        if meets(groups[g])]
                for k in range(0, len(hits), nt // 32):
                    chunk = [f for g in hits[k:k + nt // 32]
                             for f in range(32 * g, min(32 * g + 32,
                                                        len(faces)))
                             if meets(box[f])]
                    met += len(chunk)
                    if chunk and len(lst) + len(chunk) > cap:
                        walk(lst)
                        walks, lst = walks + 1, []
                    lst += chunk
            walk(lst)
            walks += 1
            most = max(most, met)
            # the least (depth, face) of the pixel's threads (no face: -1
            # under +inf, which every face's finite depth beats)
            key = np.lexsort((np.where(won < 0, np.iinfo(np.int64).max, won),
                              best), axis=0)[0]
            best = np.take_along_axis(best, key[None], 0)[0]
            won = np.take_along_axis(won, key[None], 0)[0]
            bw = np.take_along_axis(bw, key[None, ..., None], 0)[0]
            sel = won >= 0
            tri, zb = faces[won[sel]], zf[won[sel]]
            a, pz = bw[sel], best[sel]
            attr = (a[:, :1] * colors[tri[:, 0]] / zb[:, :1]
                    + a[:, 1:2] * colors[tri[:, 1]] / zb[:, 1:2]
                    + a[:, 2:] * colors[tri[:, 2]] / zb[:, 2:]) * pz[:, None]
            patch = color[ty0:ty1, tx0:tx1]
            patch[sel] = attr
    return np.clip(color, 0.0, 1.0), most, walks


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", ["crowded", "large", "off-screen", "1x1",
                                  "17x13"])
def test_tile_walk_matches_jax(case, geometry):
    """The kernel's walk, replayed at its geometry, is the loop's image bit
    for bit; the crowded mesh meets one tile with more faces than the list
    holds, so the list is walked more than once there."""
    tile, sub, cap = GEOMETRIES[geometry]
    px, z, faces, colors, bg, far = raster_edge_cases(tile, cap)[case]
    with np.errstate(all="ignore"):
        got, most, walks = _replay_tiles(px, z, faces, colors, bg, 1.0, far,
                                         tile, sub, cap)
    want = jm.rasterize_mesh(px, z, faces, colors, bg, near=1.0, far=far)
    np.testing.assert_array_equal(got, want)
    tiles = -(-bg.shape[0] // tile[1]) * -(-bg.shape[1] // tile[0])
    if case == "crowded":
        assert most > cap and walks > tiles
    assert (got != np.clip(bg, 0, 1)).any()  # some face drew


def test_tile_walk_on_the_hand_mesh_matches_jax(mesh):
    """The kernel's geometry over the MANO-sized mesh at 224x224, its
    coplanar copies included."""
    v, f, colors = mesh
    px, z = jm.project_points(v, np.zeros(3), np.array([0.01, -0.02, 2.0]),
                              np.array([1500.0, 1500.0]),
                              np.array([112.0, 112.0]))
    bg = np.random.default_rng(6).uniform(0, 1, (224, 224, 3))
    with np.errstate(all="ignore"):
        got, _, _ = _replay_tiles(px, z, f, colors, bg, 1.0, 10.0,
                                  *choose_geometry(224, 224, 132))
    np.testing.assert_array_equal(
        got, jm.rasterize_mesh(px, z, f, colors, bg, near=1.0, far=10.0))


@pytest.mark.parametrize("case", ["crowded", "large", "off-screen", "1x1",
                                  "17x13"])
def test_twin_on_edge_cases_matches_jax(case):
    px, z, faces, colors, bg, far = raster_edge_cases(*SMALL[::2])[case]
    got = rasterize_mesh_plain(*(torch.from_numpy(a) for a in
                                 (px, z, faces, colors, bg)),
                               near=1.0, far=far)
    want = jm.rasterize_mesh(px, z, faces, colors, bg, near=1.0, far=far)
    np.testing.assert_array_equal(got.numpy(), want)


def test_depth_bound_holds_inside_triangles():
    """``beyond`` drops a face once its bound, min(zmin (1 - 2^-48), 1e12),
    is above a pixel's best: inside a triangle the computed depth (the
    loop's expressions, with the kernel's NaN-passing fmax) must never be
    below that bound, over depths from 2^-899 to 1e13, thin and wide
    triangles, and a NaN depth."""
    src = (Path(__file__).parents[1] / "lighthand_tpu_torch" / "csrc"
           / "rasterize.cu").read_text()
    assert ("return zmin >= 0x1p-900 && best < fmin(zmin * (1.0 - "
            "0x1p-48), 1e12);") in src
    rng = np.random.default_rng(9)
    n = 3000
    p = rng.uniform(0, 40, size=(n, 3, 2))
    p[: n // 4, 2] = p[: n // 4, 0] + rng.uniform(-1e-3, 1e-3, (n // 4, 2))
    z = 10.0 ** rng.uniform(-3, 13, size=(n, 3))
    z[::7] = rng.uniform(1.9, 2.1, size=(len(z[::7]), 3))
    z[::11, 1] = 2.0 ** -899
    z[5::13, 2] = np.nan
    denom = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    xs, ys = np.meshgrid(np.arange(40) + 0.5, np.arange(40) + 0.5)
    checked = 0
    with np.errstate(all="ignore"):
        for t in range(n):
            pf, zf = p[t], z[t]
            w1 = ((xs - pf[0, 0]) * (pf[2, 1] - pf[0, 1])
                  - (pf[2, 0] - pf[0, 0]) * (ys - pf[0, 1])) / denom[t]
            w2 = ((pf[1, 0] - pf[0, 0]) * (ys - pf[0, 1])
                  - (xs - pf[0, 0]) * (pf[1, 1] - pf[0, 1])) / denom[t]
            w0 = 1.0 - w1 - w2
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            inv_z = w0 / zf[0] + w1 / zf[1] + w2 / zf[2]
            pix_z = 1.0 / np.fmax(inv_z, 1e-12)
            key = _near_key(zf[None])[0]
            if key >= 2.0 ** -900 and inside.any():
                bound = min(key * (1 - 2.0 ** -48), 1e12)
                assert (pix_z[inside] >= bound).all(), t
                checked += int(inside.sum())
    assert checked > 50_000


def test_geometry_follows_the_pixels_an_sm():
    assert choose_geometry(600, 800, 132) == LARGE
    assert choose_geometry(224, 224, 132) == SMALL
    for tile, sub, cap in (LARGE, SMALL):
        threads = tile[0] * tile[1] * sub
        assert threads % 32 == 0 and threads <= 512 and cap >= threads
        assert sub in (1, 2, 4)
