"""The port's text (``utils/font.py``, ``csrc/text.cpp``,
``utils/visualize.py:put_text``, ``utils/vis3d.py:draw_text``) against cv2
5.0.0's FontFace ``putText`` and the JAX package's ``draw_text``.

Tolerance: none. Every image must equal cv2's byte for byte (the count of
differing pixels is printed on failure), every returned pen position must
equal cv2's, and ``draw_text`` must equal the JAX function as float64
arrays. Inputs come from numpy seeds and hypothesis. Code points Rubik
lacks, control characters and right-to-left text raise ``ValueError``: a
difference by design (cv2 draws the first from another built-in font).
"""

import pathlib
import subprocess
import sys
import unicodedata

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lighthand_tpu.utils import vis3d as jv
from lighthand_tpu_torch.utils import font
from lighthand_tpu_torch.utils import vis3d as tv
from lighthand_tpu_torch.utils.visualize import put_text

REPO = pathlib.Path(__file__).resolve().parents[1]
FACE = font.rubik()
ASCII = "".join(chr(c) for c in range(32, 127))
LATIN1 = "".join(chr(c) for c in range(0xA0, 0x100)
                 if unicodedata.category(chr(c))[0] == "L"
                 and FACE.glyph_index(c))
ALPHABET = ASCII + LATIN1
WEIGHTS = (300, 400, 550, 700, 900)


def _accepted(ch):
    try:
        put_text(np.zeros((4, 4, 3), np.uint8), ch, (0, 3), (0, 0, 0))
    except ValueError:
        return False
    return True


# every code point of Rubik's cmap that put_text draws
ACCEPTED = "".join(chr(c) for c in sorted(FACE.cmap) if _accepted(chr(c)))


def cv2_put_text(img, text, org, color, size, weight):
    pen, out = cv2.putText(img, text, org, color, cv2.FontFace("sans"), size,
                           weight)
    img[...] = out.reshape(img.shape)
    return tuple(pen)


def assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    bad = got != want
    if got.ndim == 3:
        bad = bad.any(axis=2)
    assert not bad.any(), f"{what}: {int(bad.sum())} pixels differ"


def both(shape, text, org, color, size, weight, seed=0):
    """(port's image, cv2's image), each after drawing on one background."""
    bg = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    mine, ref = bg.copy(), bg.copy()
    pen = put_text(mine, text, org, color, size, weight)
    ref_pen = cv2_put_text(ref, text, org, color, size, weight)
    assert pen == ref_pen, (pen, ref_pen)
    return mine, ref


def test_font_is_the_member_of_cv2s_binary():
    """The committed font equals, byte for byte, the ``Rubik.ttf`` gzip
    member of the installed cv2 5.0 module, as the extraction script
    unpacks it."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import extract_cv2_font
    finally:
        sys.path.pop(0)
    so = extract_cv2_font.cv2_module_path()
    data = extract_cv2_font.find_member(so.read_bytes())
    assert data == font.FONT_PATH.read_bytes()
    assert len(data) == 359916


def test_reader_tables_equal_fonttools():
    """The reader's cmap, advances, axes and default outlines' boxes equal
    fontTools' reading of the same file."""
    from fontTools.ttLib import TTFont

    tt = TTFont(str(font.FONT_PATH))
    assert FACE.cmap == {c: tt.getGlyphID(g)
                         for c, g in tt.getBestCmap().items()}
    assert (FACE.ascent, FACE.descent, FACE.units_per_em) == (935, -250, 1000)
    assert FACE.axes == [("wght", 300 << 16, 300 << 16, 900 << 16)]
    order = tt.getGlyphOrder()
    for cp in map(ord, ALPHABET):
        g = FACE.glyph_index(cp)
        name = order[g]
        assert FACE.hmetrics(g) == tuple(tt["hmtx"][name])
        out = FACE.outline(g, 300)
        assert out.advance == tt["hmtx"][name][0]
        glyf = tt["glyf"][name]
        if glyf.numberOfContours:
            assert out.box == (glyf.xMin, glyf.yMin, glyf.xMax, glyf.yMax)
            if not glyf.isComposite():
                on = [tuple(p) for p, f in zip(glyf.coordinates, glyf.flags)
                      if f & 1]
                assert {tuple(v[1:3]) for v in out.vertices.tolist()} >= set(on)


def test_weight_normalisation_and_avar():
    """wght 400 normalises to F2Dot14 2731 and maps through avar to 3072
    (0.1875); 100-300 clamp to the default; 900 and above to 1.0."""
    assert FACE.normalized(400) == (3072,)
    assert FACE.normalized(100) == FACE.normalized(300) == (0,)
    assert FACE.normalized(900) == FACE.normalized(1000) == (16384,)
    assert FACE.normalized(700) == (10240,)


@pytest.mark.parametrize("weight", WEIGHTS)
def test_default_and_varied_advances_equal_cv2(weight):
    """Every glyph of the alphabet alone at size 20: the pen's end (the
    advance) and the pixels equal cv2's."""
    for k, ch in enumerate(ALPHABET):
        mine, ref = both((40, 40, 3), ch, (10, 28), (255, 255, 255), 20,
                         weight, seed=k)
        assert_same(mine, ref, f"{ch!r} at weight {weight}")


def test_accepted_code_points():
    """put_text draws every code point of Rubik's cmap but one control
    character and the right-to-left letters."""
    refused = [chr(c) for c in FACE.cmap if not _accepted(chr(c))]
    assert len(FACE.cmap) == 885 and len(ACCEPTED) == 668
    assert set(ALPHABET) <= set(ACCEPTED)
    assert all(unicodedata.category(ch)[0] == "C"
               or unicodedata.bidirectional(ch) in ("R", "AL")
               for ch in refused)


@pytest.mark.parametrize("weight", WEIGHTS)
def test_every_accepted_code_point_equals_cv2(weight):
    """Each code point put_text accepts (Latin Extended, Greek, Cyrillic,
    symbols such as ``©®°½`` besides the alphabet) alone at sizes 8, 11, 16
    and 24: the pen's end and the pixels equal cv2's."""
    for size in (8, 11, 16, 24):
        for k, ch in enumerate(ACCEPTED):
            mine, ref = both((3 * size, 3 * size, 3), ch,
                             (size // 2, 2 * size), (255, 0, 90), size,
                             weight, seed=k)
            assert_same(mine, ref, f"U+{ord(ch):04X} size {size} "
                                   f"weight {weight}")


@pytest.mark.parametrize("weight", WEIGHTS)
def test_every_glyph_reads(weight):
    """Every glyph of the font, reachable from the cmap or not, reads at
    the five weights (no composite is placed by matching points)."""
    for g in range(FACE.num_glyphs):
        out = FACE.outline(g, weight)
        assert out.vertices.ndim == 2


@pytest.mark.parametrize("size", range(8, 25))
@pytest.mark.parametrize("weight", WEIGHTS)
def test_put_text_equals_cv2(size, weight):
    """The whole alphabet (printable ASCII and Rubik's Latin-1 letters) in
    lines over a random background in a random colour."""
    rng = np.random.default_rng(size * 1000 + weight)
    color = tuple(int(c) for c in rng.integers(0, 256, 3))
    width = 40 * size
    for k in range(0, len(ALPHABET), 40):
        text = ALPHABET[k:k + 40]
        mine, ref = both((2 * size, width, 3), text, (3, int(1.4 * size)),
                         color, size, weight, seed=k)
        assert_same(mine, ref, f"{text!r} size {size} weight {weight}")


@pytest.mark.parametrize("shape,org", [
    ((30, 80, 3), (-9, 20)), ((30, 80, 3), (60, 20)), ((30, 80, 3), (5, 4)),
    ((30, 80, 3), (5, 34)), ((30, 80, 3), (-30, -2)), ((30, 80, 3), (79, 29)),
    ((1, 1, 3), (0, 5)), ((1, 1, 3), (-3, 1)), ((13, 17, 3), (-2, 10)),
    ((13, 17, 3), (4, 16)),
])
def test_put_text_clips_at_every_edge(shape, org):
    """Origins that cut the text at each edge of the image, 1x1 and 17x13
    images."""
    for seed, weight in enumerate((300, 400, 700)):
        mine, ref = both(shape, "Wg|Q}j@ÅÿßÉ", org, (10, 200, 30, 250), 16,
                         weight, seed=seed)
        assert_same(mine, ref, f"{shape} at {org}")


@pytest.mark.parametrize("img", [
    np.zeros((20, 50), np.uint8), np.zeros((20, 50, 1), np.uint8),
    np.zeros((20, 50, 4), np.uint8), np.zeros((20, 50, 3), np.float32),
    np.zeros((20, 100, 3), np.uint8)[:, ::2],
], ids=["2d", "1ch", "4ch", "f32", "strided"])
def test_put_text_refuses_other_images(img):
    """put_text draws into packed uint8 [H, W, 3] images only."""
    with pytest.raises(ValueError, match="uint8"):
        put_text(img, "pck: 0.88", (2, 15), (77, 0, 0))
    assert not img.any()


def test_nothing_drawn_from_right_of_the_image():
    """From org.x >= W, cv2 draws nothing and returns org."""
    for x in (40, 41, 100):
        mine, ref = both((20, 40, 3), "Hello", (x, 15), (0, 0, 0), 11, 400)
        assert_same(mine, ref)
        assert put_text(mine, "Hello", (x, 15), (0, 0, 0)) == (x, 15)


@settings(max_examples=60, deadline=None)
@given(text=st.text(alphabet=ALPHABET, max_size=16),
       x=st.integers(-40, 100), y=st.integers(-10, 60),
       size=st.integers(6, 40), weight=st.integers(50, 1100),
       color=st.tuples(*[st.integers(0, 255)] * 3),
       seed=st.integers(0, 2 ** 16))
def test_put_text_equals_cv2_hypothesis(text, x, y, size, weight, color,
                                        seed):
    mine, ref = both((50, 90, 3), text, (x, y), color, size, weight,
                     seed=seed)
    assert_same(mine, ref, f"{text!r} at {(x, y)} size {size} w {weight}")


@pytest.mark.parametrize("seed", range(4))
def test_hershey_call_is_size_11_weight_400(seed):
    """``draw_text``'s call, ``cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, 0.4, color, 1)``, equals ``put_text(..., 11,
    400)``."""
    rng = np.random.default_rng(seed)
    text = "".join(rng.choice(list(ALPHABET), 18))
    bg = rng.integers(0, 256, (40, 160, 3)).astype(np.uint8)
    color = tuple(int(c) for c in rng.integers(0, 256, 3))
    org = (int(rng.integers(-5, 20)), int(rng.integers(5, 45)))
    ref = cv2.putText(bg.copy(), text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                      color, 1)
    mine = bg.copy()
    put_text(mine, text, org, color, 11, 400)
    assert_same(mine, ref, text)


def _image(seed, h, w, margin=8):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.3, 1.3, (h, w, 3))
    img[:margin] = 0.0
    img[:, :margin // 2] = 0.0
    img[h - margin:] = 0.0
    return img


@pytest.mark.parametrize("seed,h,w,rows", [
    (0, 96, 128, 2), (1, 64, 200, 5), (2, 40, 90, 6), (3, 256, 256, 3),
    (4, 32, 32, 4), (5, 120, 60, 9),
])
def test_draw_text_equals_jax(seed, h, w, rows):
    """Random images with black letterbox margins and out-of-range values;
    float, numpy float64 / float32, int, str and bool values; rows running
    off the bottom and the right."""
    rng = np.random.default_rng(seed)
    values = [float(rng.uniform(-5, 5)), np.float64(rng.uniform()),
              np.float32(rng.uniform()), int(rng.integers(-99, 999)),
              "hand", bool(seed % 2), 1e6, -0.004]
    content = {f"k{i}": values[i % len(values)] for i in range(rows)}
    img = _image(seed, h, w)
    got, want = tv.draw_text(img, content), jv.draw_text(img, content)
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want), \
        f"{int((got != want).any(axis=2).sum())} pixels differ"


def test_draw_text_leaves_input_and_whitens_black():
    img = _image(9, 48, 64)
    before = img.copy()
    out = tv.draw_text(img, {})
    assert np.array_equal(img, before)
    assert (out[:8] == 1.0).all()
    assert np.array_equal(out, jv.draw_text(img, {}))


@pytest.mark.parametrize("text,match", [
    ("中", "not in Rubik"), ("a\nb", "control"),
    ("א", "right-to-left"), ("ا", "right-to-left"),
])
def test_unsupported_code_points_raise(text, match):
    img = np.zeros((20, 40, 3), np.uint8)
    with pytest.raises(ValueError, match=match):
        put_text(img, text, (2, 15), (255, 255, 255))
    assert not img.any()
    with pytest.raises(ValueError, match=match):
        tv.draw_text(np.ones((20, 40, 3)), {"k": text})


@pytest.mark.parametrize("drawer", ["port", "jax"])
def test_text_drawings_match_stored_digests(drawer):
    """``chip_smoke.py`` phase 9i's captions: the port's equal the digests
    stored from the JAX package's and cv2 5.0.0's
    (``tests/fixtures/text_digests.json``), which the card's machine checks
    without cv2; and cv2 still draws them, so the fixture is current."""
    import json

    import torch_fixtures
    sys.path.insert(0, str(REPO / "tests" / "fixtures"))
    try:
        import make_text_digests
    finally:
        sys.path.pop(0)
    if drawer == "port":
        drawings = torch_fixtures.text_drawings(tv.draw_text, put_text)
    else:
        drawings = torch_fixtures.text_drawings(jv.draw_text,
                                            make_text_digests.cv2_put_text)
    got = torch_fixtures.overlay_digests(drawings)
    with open(torch_fixtures.TEXT_DIGESTS) as f:
        stored = json.load(f)
    assert stored["cv2"] == cv2.__version__ == "5.0.0"
    assert got == stored["files"] and len(got) == 13


def test_draw_text_runs_without_jax_or_cv2():
    """``draw_text`` in a fresh process loads no jax, JAX package, cv2, PIL
    or matplotlib, and reads only the committed font."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "from lighthand_tpu_torch.utils import vis3d\n"
        "out = vis3d.draw_text(np.zeros((40, 80, 3)), {'pck': 0.88})\n"
        "assert out.shape == (40, 80, 3) and (out < 1).any()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'lighthand_tpu', 'cv2', 'PIL', 'orbax', 'matplotlib', "
        "'fontTools')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
