"""The port's landmark drawing (``lighthand_tpu_torch/utils/landmarks.py``)
against the JAX package's (``lighthand_tpu/utils/landmarks.py``, which
draws with cv2).

Tolerance: none. ``draw_landmarks`` and ``draw_axis`` must give the same
pixels and the same returned coordinates on inputs made with numpy from a
seed (visible, hidden and out-of-[0, 1] landmarks, per-landmark and
per-connection specs, axes pointing off the image), and raise the same
errors; ``plot_landmarks`` must give a figure with the same scatter
offsets, line data, colours, widths and view angles.
"""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from lighthand_tpu.utils import landmarks as jl  # noqa: E402
from lighthand_tpu_torch.utils import landmarks as tl  # noqa: E402


def _landmarks(rng, n=21, cols=4, lo=-0.15, hi=1.15):
    lms = rng.uniform(lo, hi, size=(n, cols))
    if cols >= 4:
        lms[:, 3] = rng.uniform(0, 1, n)  # visibility around the threshold
    return lms


def test_constants_match_jax():
    assert tl.HAND_CONNECTIONS == jl.HAND_CONNECTIONS
    assert tl.DrawingSpec() == tl.DrawingSpec(**vars(jl.DrawingSpec()))
    for name in ("WHITE_COLOR", "BLACK_COLOR", "RED_COLOR", "GREEN_COLOR",
                 "BLUE_COLOR", "_VISIBILITY_THRESHOLD"):
        assert getattr(tl, name) == getattr(jl, name)


@pytest.mark.parametrize("xy", [(0.5, 0.5), (1.0, 1.0), (0.0, 0.0),
                                (-0.1, 0.5), (0.5, 1.0000001), (1e-17, 1.0),
                                (-1e-17, 0.3), (0.99999, 0.0), (2.0, 2.0)])
@pytest.mark.parametrize("size", [(64, 64), (7, 131), (1, 1)])
def test_normalized_to_pixel_coordinates_matches_jax(xy, size):
    assert (tl.normalized_to_pixel_coordinates(*xy, *size)
            == jl.normalized_to_pixel_coordinates(*xy, *size))


@pytest.mark.parametrize("seed", range(6))
def test_draw_landmarks_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(16, 120, 2))
    cols = [2, 3, 4, 4, 4, 4][seed]
    lms = _landmarks(rng, cols=cols)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    kw = {}
    if seed == 3:  # per-landmark and per-connection specs, thicker
        kw["landmark_drawing_spec"] = {
            i: jl.DrawingSpec(color=(i, 2 * i, 3 * i), thickness=1 + i % 4,
                              circle_radius=i % 6) for i in range(21)}
        kw["connection_drawing_spec"] = {
            c: jl.DrawingSpec(color=(9, c[1], 200), thickness=1 + c[1] % 5)
            for c in jl.HAND_CONNECTIONS}
    elif seed == 4:  # nothing but the connections, filled landmarks
        kw["landmark_drawing_spec"] = jl.DrawingSpec(thickness=-1)
    elif seed == 5:
        kw["landmark_drawing_spec"] = None
        kw["visibility_threshold"] = 0.2
    port_kw = {k: ({key: tl.DrawingSpec(**vars(s)) for key, s in v.items()}
                   if isinstance(v, dict) else
                   None if v is None else tl.DrawingSpec(**vars(v)))
               if k.endswith("spec") else v for k, v in kw.items()}
    got, want = img.copy(), img.copy()
    got_px = tl.draw_landmarks(got, lms, tl.HAND_CONNECTIONS, **port_kw)
    want_px = jl.draw_landmarks(want, lms, jl.HAND_CONNECTIONS, **kw)
    assert got_px == want_px
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def test_draw_landmarks_without_connections_and_empty():
    rng = np.random.default_rng(7)
    lms = _landmarks(rng, cols=2, lo=0.0, hi=1.0)
    got = np.zeros((50, 60, 3), np.uint8)
    want = got.copy()
    assert tl.draw_landmarks(got, lms) == jl.draw_landmarks(want, lms)
    np.testing.assert_array_equal(got, want)
    assert tl.draw_landmarks(got, np.zeros((0, 2))) == {} == \
        jl.draw_landmarks(want, np.zeros((0, 2)))


@pytest.mark.parametrize("case", ["connection", "channels"])
def test_draw_landmarks_errors_match_jax(case):
    if case == "connection":
        args = (np.zeros((8, 8, 3), np.uint8), np.array([[0.5, 0.5]]))
        kw = {"connections": [(0, 7)]}
    else:
        args = (np.zeros((8, 8, 1), np.uint8), np.array([[0.5, 0.5]]))
        kw = {}
    with pytest.raises(ValueError) as want:
        jl.draw_landmarks(*args, **kw)
    with pytest.raises(ValueError) as got:
        tl.draw_landmarks(*args, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(6))
def test_draw_axis_matches_jax(seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(100 + seed)
    h, w = (int(v) for v in rng.integers(20, 160, 2))
    rot = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    t = np.array([*rng.normal(0, 0.05, 2), rng.uniform(-0.6, -0.2)])
    kw = dict(focal_length=tuple(rng.uniform(0.5, 3.0, 2)),
              principal_point=tuple(rng.normal(0, 0.2, 2)),
              axis_length=float(rng.uniform(0.05, 0.4)))
    thickness = int(rng.integers(1, 5))
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    got, want = img.copy(), img.copy()
    tl.draw_axis(got, rot, t, axis_drawing_spec=tl.DrawingSpec(
        thickness=thickness), **kw)
    jl.draw_axis(want, rot, t, axis_drawing_spec=jl.DrawingSpec(
        thickness=thickness), **kw)
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()


def test_draw_axis_default_spec_matches_jax():
    got = np.zeros((48, 64, 3), np.uint8)
    want = got.copy()
    rot, t = np.eye(3), np.array([0.01, -0.02, -0.5])
    tl.draw_axis(got, rot, t)
    jl.draw_axis(want, rot, t)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    with pytest.raises(ValueError):
        tl.draw_axis(np.zeros((8, 8), np.uint8), rot, t)


def _figure_data(fig):
    """What a 3D landmark figure shows: each scatter's offsets (x, y and
    the depth), colours and widths; each line's data, colour and width; the
    view angles."""
    (ax,) = fig.axes
    scatters = [(np.asarray(c._offsets3d, dtype=np.float64).tolist(),
                 c.get_facecolor().tolist(), c.get_linewidths().tolist())
                for c in ax.collections]
    lines = [(np.asarray(ln.get_data_3d(), dtype=np.float64).tolist(),
              list(matplotlib.colors.to_rgba(ln.get_color())),
              ln.get_linewidth()) for ln in ax.lines]
    return scatters, lines, (ax.elev, ax.azim), fig.get_size_inches().tolist()


@pytest.mark.parametrize("cols", [2, 3, 4])
def test_plot_landmarks_figure_matches_jax(cols):
    import matplotlib.pyplot as plt

    lms = _landmarks(np.random.default_rng(cols), cols=cols, lo=0, hi=1)
    kw = dict(elevation=25, azimuth=-40)
    got = tl.plot_landmarks(lms, tl.HAND_CONNECTIONS, **kw)
    want = jl.plot_landmarks(lms, jl.HAND_CONNECTIONS, **kw)
    try:
        got_data, want_data = _figure_data(got), _figure_data(want)
        assert got_data == want_data
        assert got_data[0] and (got_data[1] or cols >= 4)
    finally:
        plt.close(got)
        plt.close(want)
    with pytest.raises(ValueError, match="out of range"):
        tl.plot_landmarks(lms, [(0, 40)])
    plt.close("all")
