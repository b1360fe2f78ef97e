"""The port's skeleton renderers (``lighthand_tpu_torch/utils/vis3d.py``)
against the JAX package's (``lighthand_tpu/utils/vis3d.py``, which draws
and writes with cv2).

Tolerance: none. ``vis_keypoints`` must give the same array (HWC, CHW and
one-channel input; score gating; thick bones) and, given a ``.jpg`` or
``.jpeg`` name, the same file bytes; given a ``.png`` name, a file whose
pixels (read by the port's own decoder and by cv2) equal the JAX file's,
and whose bytes equal it too where Python's ``zlib`` deflates as cv2
5.0.0's libpng does (its filter, level, strategy and window). Another extension
raises ``ValueError`` where cv2 would pick another encoder: a difference
by design. ``vis_3d_keypoints`` must give a figure with the same lines,
scatters and colours. ``draw_text`` must give the JAX array, float64 for
float64 (``tests/test_torch_text.py`` holds it on many more cases).
"""

import os

import matplotlib

matplotlib.use("Agg")

import cv2  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from lighthand_tpu.utils import vis3d as jv  # noqa: E402
from lighthand_tpu_torch.data.imageio import (  # noqa: E402
    encode_png_rgb,
    imdecode_rgb,
    imread_rgb,
)
from lighthand_tpu_torch.utils import vis3d as tv  # noqa: E402

SKELETON = jv.hand_skeleton_21()


def _case(seed, h=72, w=96, layout="hwc"):
    rng = np.random.default_rng(seed)
    kps = rng.uniform(-12, max(h, w) + 12, size=(21, 2))
    score = rng.uniform(0, 1, 21)
    if layout == "chw":
        img = rng.integers(0, 256, size=(3, h, w)).astype(np.float64)
    elif layout == "gray":
        img = rng.integers(0, 256, size=(h, w, 1), dtype=np.uint8)
    else:
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    return img, kps, score


def test_skeleton_and_colours_match_jax():
    assert tv.hand_skeleton_21() == SKELETON
    extra = SKELETON + [{"name": "r_thumb_null", "parent_id": 4},
                        {"name": "l_pinky_null", "parent_id": 20},
                        {"name": "nose", "parent_id": -1}]
    assert tv.get_keypoint_rgb(extra) == jv.get_keypoint_rgb(extra)


@pytest.mark.parametrize("layout", ["hwc", "chw", "gray"])
@pytest.mark.parametrize("seed", range(4))
def test_vis_keypoints_matches_jax(layout, seed):
    img, kps, score = _case(seed, layout=layout)
    kw = [{}, {"line_width": 5, "circle_rad": 1}, {"score_thr": 0.1},
          {"line_width": 2, "circle_rad": 6, "score_thr": 0.6}][seed]
    got = tv.vis_keypoints(img, kps, score, SKELETON, **kw)
    want = jv.vis_keypoints(img, kps, score, SKELETON, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == (72, 96, 3)
    assert (got != np.asarray(want)).sum() == 0 and got.any()


@pytest.mark.parametrize("name", ["a/kp.jpg", "kp.jpeg", "KP.JPG"])
def test_vis_keypoints_jpeg_file_bytes_match_jax(tmp_path, name):
    img, kps, score = _case(10)
    got = tv.vis_keypoints(img, kps, score, SKELETON, filename=name,
                           save_path=str(tmp_path / "port"))
    want = jv.vis_keypoints(img, kps, score, SKELETON, filename=name,
                            save_path=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)
    port = (tmp_path / "port" / name).read_bytes()
    assert port == (tmp_path / "jax" / name).read_bytes()
    assert port[:2] == b"\xff\xd8"


def test_vis_keypoints_png_decodes_to_cv2s_pixels(tmp_path):
    img, kps, score = _case(11, h=61, w=83)
    out = str(tmp_path / "port.png")
    canvas = tv.vis_keypoints(img, kps, score, SKELETON, filename=out)
    jv.vis_keypoints(img, kps, score, SKELETON,
                     filename=str(tmp_path / "jax.png"))
    port_px = imread_rgb(out)
    np.testing.assert_array_equal(port_px, canvas)
    np.testing.assert_array_equal(port_px,
                                  imread_rgb(str(tmp_path / "jax.png")))
    np.testing.assert_array_equal(
        cv2.cvtColor(cv2.imread(out), cv2.COLOR_BGR2RGB), canvas)
    # and cv2 5.0.0's bytes
    assert (tmp_path / "port.png").read_bytes() == \
        (tmp_path / "jax.png").read_bytes()


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (37, 53),
                                   (130, 140), (200, 300)])
def test_png_encoder_matches_cv2(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = rng.integers(0, 256, size=shape + (3,), dtype=np.uint8)
    img[: shape[0] // 2] //= 64  # runs for the RLE strategy
    data = encode_png_rgb(img)
    np.testing.assert_array_equal(imdecode_rgb(data), img)
    ok, want = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok and data == want.tobytes()


@pytest.mark.parametrize("name", ["kp.bmp", "kp.webp", "kp"])
def test_vis_keypoints_other_extension_raises(tmp_path, name):
    """A difference by design: cv2 would write these (or fail) with another
    encoder; the port writes JPEG and PNG only and raises before writing."""
    img, kps, score = _case(12)
    out = tmp_path / "sub" / name
    with pytest.raises(ValueError, match=r"\.jpg, \.jpeg and \.png"):
        tv.vis_keypoints(img, kps, score, SKELETON, filename=str(out))
    assert not out.exists() and not out.parent.exists()


def test_draw_text_matches_jax_on_a_fixed_image():
    """The caption strip equals the JAX package's (cv2 5.0.0) as float64;
    ``tests/test_torch_text.py`` holds it and ``put_text`` further."""
    img = np.random.default_rng(11).uniform(0, 1, (72, 96, 3))
    img[:10] = 0.0
    content = {"pck": 0.8812, "auc": np.float32(0.5), "epoch": 3}
    got, want = tv.draw_text(img, content), jv.draw_text(img, content)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


def _figure_data(fig):
    (ax,) = fig.axes
    lines = [(np.asarray(ln.get_data_3d(), dtype=np.float64).tolist(),
              list(matplotlib.colors.to_rgba(ln.get_color())),
              ln.get_linewidth()) for ln in ax.lines]
    scatters = [(np.asarray(c._offsets3d, dtype=np.float64).tolist(),
                 c.get_facecolor().tolist(), c.get_paths()[0].vertices
                 .tolist()) for c in ax.collections]
    return lines, scatters


@pytest.mark.parametrize("seed", range(3))
def test_vis_3d_keypoints_figure_matches_jax(tmp_path, seed):
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(20 + seed)
    kps = rng.normal(size=(21, 3))
    score = rng.uniform(0, 1, 21)
    kw = [{}, {"score_thr": 0.2, "line_width": 1}, {"score_thr": 0.7}][seed]
    path = str(tmp_path / "d" / "kp3d.png")
    got = tv.vis_3d_keypoints(kps, score, SKELETON, filename=path, **kw)
    want = jv.vis_3d_keypoints(kps, score, SKELETON, **kw)
    try:
        assert _figure_data(got) == _figure_data(want)
        assert _figure_data(got)[0] and os.path.getsize(path) > 0
    finally:
        plt.close(got)
        plt.close(want)


@pytest.mark.parametrize("drawer", ["port", "jax"])
def test_overlay_drawings_match_stored_digests(tmp_path, drawer):
    """``chip_smoke.py`` phase 9g's drawings (thick lines, outline circles,
    arrows, landmark and axis overlays, ``vis_keypoints`` and its JPEG):
    the port's equal the digests stored from the JAX package's cv2 5.0.0
    drawings (``tests/fixtures/overlay_digests.json``), which the card's
    machine checks without cv2; and the JAX package still draws them, so
    the fixture is current."""
    import json

    import torch_fixtures
    from lighthand_tpu.utils import landmarks as jl
    from lighthand_tpu_torch.utils import landmarks as tl
    from lighthand_tpu_torch.utils import visualize

    if drawer == "port":
        prims = (visualize.draw_line, visualize.draw_circle,
                 visualize.draw_arrowed_line, tl, tv)
    else:
        prims = (lambda img, a, b, c, t: cv2.line(img, a, b, c, t),
                 lambda img, o, r, c, t: cv2.circle(img, o, r, c, t),
                 lambda img, a, b, c, t: cv2.arrowedLine(img, a, b, c, t),
                 jl, jv)
    got = torch_fixtures.overlay_digests(torch_fixtures.overlay_drawings(
        *prims, str(tmp_path)))
    with open(torch_fixtures.OVERLAY_DIGESTS) as f:
        stored = json.load(f)
    assert stored["cv2"] == cv2.__version__ == "5.0.0"
    assert got == stored["files"] and len(got) == 11
