"""The port's JPEG encoder (``data/imageio.py:encode_jpeg_rgb`` /
``imwrite_rgb`` over ``csrc/imageio.cpp``) against ``cv2.imencode`` /
``cv2.imwrite``, which the JAX package calls (libjpeg-turbo inside cv2).

Tolerance: none. Every case compares the bytes, and then the decodes of
those bytes (the port's decoder against cv2's): the fixture JPEGs decoded,
sizes from 1x1 up (not multiples of 16), gray and RGB, qualities 1 to 100
(at 100 every table entry is 1; under 25 entries clamp to 255), and sizes,
qualities and contents drawn by hypothesis.
"""

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from lighthand_tpu_torch.data import imageio

JPEGS = [e for e in chip_smoke.load_manifest() if e["kind"] == "jpeg"]
QUALITIES = [1, 10, 50, 75, 90, 95, 100]
SIZES = [(1, 1), (7, 9), (15, 17), (224, 224), (517, 771)]
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True)


def _cv2_bytes(img: np.ndarray, quality: int) -> bytes:
    bgr = img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


def _cv2_decode(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _check(img: np.ndarray, quality: int) -> None:
    got = imageio.encode_jpeg_rgb(img, quality)
    want = _cv2_bytes(img, quality)
    assert got == want, (img.shape, quality, len(got), len(want))
    np.testing.assert_array_equal(imageio.imdecode_rgb(got),
                                  _cv2_decode(want))


def _image(seed: int, h: int, w: int, gray: bool, smooth: bool = True):
    rng = np.random.default_rng(seed)
    c = 1 if gray else 3
    if smooth:  # photo-like: coarse structure plus noise
        base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c),
                            dtype=np.uint8)
        img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
        img = img.reshape(h, w, c).astype(int) + rng.integers(-24, 24,
                                                              (h, w, c))
        img = np.clip(img, 0, 255).astype(np.uint8)
    else:
        img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return img[..., 0] if gray else img


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("entry", JPEGS, ids=[e["file"] for e in JPEGS])
def test_fixture_images_encode_as_cv2(entry, quality):
    img = _cv2_decode(open(entry["path"], "rb").read())
    _check(img, quality)
    if entry["file"].startswith("hand_gray"):
        _check(np.ascontiguousarray(img[..., 0]), quality)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_sizes_and_qualities_encode_as_cv2(size, gray, quality):
    h, w = size
    _check(_image(h * 1000 + w, h, w, gray), quality)
    if h * w <= 224 * 224:  # noise: long AC runs of large values
        _check(_image(h + w, h, w, gray, smooth=False), quality)


@SETTINGS
@given(h=st.integers(1, 80), w=st.integers(1, 80),
       quality=st.integers(0, 100), gray=st.booleans(), smooth=st.booleans(),
       seed=st.integers(0, 2**31 - 1))
def test_drawn_images_encode_as_cv2(h, w, quality, gray, smooth, seed):
    _check(_image(seed, h, w, gray, smooth), quality)


def test_flat_and_extreme_images_encode_as_cv2():
    """Constant blocks (every AC zero: EOB only), black and white (the
    largest DC steps), and a checkerboard (0xFF bytes to stuff)."""
    yy, xx = np.mgrid[:40, :56]
    board = (((yy // 1 + xx // 1) % 2) * 255).astype(np.uint8)
    for img in (np.zeros((33, 47, 3), np.uint8),
                np.full((33, 47, 3), 255, np.uint8),
                np.stack([board, 255 - board, board], -1), board):
        for q in (1, 50, 100):
            _check(img, q)


def test_imwrite_rgb_writes_cv2s_file(tmp_path):
    img = _image(5, 61, 43, False)
    imageio.imwrite_rgb(str(tmp_path / "port.jpg"), img)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), cv2.cvtColor(img,
                                                        cv2.COLOR_RGB2BGR))
    assert (tmp_path / "port.jpg").read_bytes() == (
        tmp_path / "cv2.jpg").read_bytes()


def test_bad_arguments_raise():
    img = np.zeros((8, 8, 3), np.uint8)
    for q in (-1, 101):
        with pytest.raises(ValueError, match="quality"):
            imageio.encode_jpeg_rgb(img, q)
    for bad in (img.astype(np.float32), np.zeros((8, 8, 4), np.uint8),
                np.zeros((8,), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            imageio.encode_jpeg_rgb(bad)
    with pytest.raises(ValueError, match="unsupported"):
        imageio.encode_jpeg_rgb(np.zeros((0, 8, 3), np.uint8))
