"""The port's image codec (``lighthand_tpu_torch/data/imageio.py`` over
``csrc/imageio.cpp``) against cv2, which the JAX package's readers call.

Tolerance: none. Decode, gray decode, resize (``INTER_LINEAR``) and the
inverse affine warp (``INTER_LINEAR | WARP_INVERSE_MAP``, border 0) are
bit-exact with this machine's cv2 on every case here: the committed
fixtures (checked against the SHA-256 digests cv2 gave when they were
made), and JPEGs, PNGs, sizes, qualities and matrices drawn by hypothesis.
"""

import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from lighthand_tpu_torch.data import imageio

MANIFEST = chip_smoke.load_manifest()
SETTINGS = settings(max_examples=20, deadline=None, derandomize=True)


def _sha(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv_rgb(buf: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _image(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """Smooth content with noise, like a photo (pure noise JPEGs are not
    what the decoder meets)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, c), dtype=np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    img = img.reshape(h, w, c).astype(int) + rng.integers(-24, 24, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("op", ["decode", "gray", "resize256", "warp224"])
@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_fixtures_match_cv2_digests(entry, op):
    path = entry["path"]
    if op == "gray":
        got = imageio.imread_gray(path)
    else:
        got = imageio.imread_rgb(path)
        assert list(got.shape) == entry["shape"]
        if op == "resize256":
            got = imageio.resize_linear(got, 256)
        elif op == "warp224":
            got = imageio.warp_affine_inverse(got, np.asarray(entry["warp"]),
                                              (224, 224))
    assert _sha(got) == entry["sha256"][op], (entry["file"], op)


def test_fixtures_are_small_and_cover_the_kinds():
    sizes = [os.path.getsize(e["path"]) for e in MANIFEST]
    assert sum(sizes) < 1 << 20
    names = " ".join(e["file"] for e in MANIFEST)
    for kind in ("420", "444", "422", "gray", "rst", "97x131", "exif6",
                 "rgb8.png", "rgb16.png", "palette.png", "mask_gray.png"):
        assert kind in names


_SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@SETTINGS
@given(h=st.integers(1, 160), w=st.integers(1, 160),
       quality=st.integers(5, 100), sampling=st.sampled_from(sorted(_SAMPLING)),
       restart=st.sampled_from([0, 0, 1, 3, 7]), seed=st.integers(0, 99))
def test_jpeg_decode_matches_cv2(h, w, quality, sampling, restart, seed):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    buf = cv2.imencode(".jpg", _image(seed, h, w), params)[1].tobytes()
    np.testing.assert_array_equal(imageio.imdecode_rgb(buf), _cv_rgb(buf))


@SETTINGS
@given(h=st.integers(1, 120), w=st.integers(1, 120),
       quality=st.integers(5, 100), seed=st.integers(0, 99))
def test_gray_jpeg_and_gray_read_match_cv2(tmp_path_factory, h, w, quality,
                                           seed):
    path = str(tmp_path_factory.mktemp("g") / "g.jpg")
    gray = _image(seed, h, w, 1)[..., 0]
    cv2.imwrite(path, gray, [cv2.IMWRITE_JPEG_QUALITY, quality])
    np.testing.assert_array_equal(imageio.imread_rgb(path),
                                  cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(imageio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def _exif_jpeg(orientation: int, order: bytes) -> bytes:
    e = "<" if order == b"II" else ">"
    tiff = (order + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    buf = cv2.imencode(".jpg", _image(3, 40, 24),
                       [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()
    return (buf[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
            + buf[2:])


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["le", "be"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(tmp_path, orientation, order):
    buf = _exif_jpeg(orientation, order)
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(imageio.imread_rgb(path), want)
    np.testing.assert_array_equal(imageio.imdecode_rgb(buf), _cv_rgb(buf))
    np.testing.assert_array_equal(imageio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_matches_cv2(orientation):
    """cv2 applies a PNG's eXIf chunk too."""
    tiff = (b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(">I", 0))
    buf = cv2.imencode(".png", _image(4, 10, 20))[1].tobytes()
    at = buf.index(b"IDAT") - 4
    body = (struct.pack(">I", len(tiff)) + b"eXIf" + tiff
            + struct.pack(">I", zlib.crc32(b"eXIf" + tiff) & 0xFFFFFFFF))
    png = buf[:at] + body + buf[at:]
    np.testing.assert_array_equal(imageio.imdecode_rgb(png), _cv_rgb(png))


def _png(w, h, color_type, depth, rows, plte=None, interlace=0) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    return (out + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def _packed_rows(values: np.ndarray, depth: int, filt: int = 0) -> list:
    rows = []
    for r in values:
        bits = "".join(format(int(v), f"0{depth}b") for v in r)
        bits += "0" * (-len(bits) % 8)
        rows.append(bytes([filt]) + bytes(int(bits[i:i + 8], 2)
                                          for i in range(0, len(bits), 8)))
    return rows


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("color_type", [0, 3], ids=["gray", "palette"])
def test_subbyte_and_palette_png_match_cv2(tmp_path, color_type, depth):
    rng = np.random.default_rng(depth)
    h, w = 11, 29
    vals = rng.integers(0, min(16, 1 << depth), (h, w))
    pal = rng.integers(0, 256, (16, 3), dtype=np.uint8).tobytes()
    buf = _png(w, h, color_type, depth, _packed_rows(vals, depth),
               pal if color_type == 3 else None)
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(buf)
    np.testing.assert_array_equal(
        imageio.imread_rgb(path), cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(imageio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@SETTINGS
@given(h=st.integers(1, 64), w=st.integers(1, 64),
       channels=st.sampled_from([1, 2, 3, 4]), wide=st.booleans(),
       strategy=st.sampled_from([cv2.IMWRITE_PNG_STRATEGY_DEFAULT,
                                 cv2.IMWRITE_PNG_STRATEGY_FILTERED,
                                 cv2.IMWRITE_PNG_STRATEGY_RLE]),
       seed=st.integers(0, 99))
def test_png_decode_matches_cv2(tmp_path_factory, h, w, channels, wide,
                                strategy, seed):
    """8- and 16-bit gray, gray+alpha (written by hand: cv2 writes none),
    RGB and RGBA, over cv2's filter strategies: filters 0-4 (Paeth
    included), 16 bits cut to the high byte, alpha stripped, libpng's
    rgb -> gray for IMREAD_GRAYSCALE."""
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if wide else np.uint8
    img = rng.integers(0, np.iinfo(dtype).max + 1, (h, w, channels),
                       dtype=dtype)
    if channels > 1:  # gray pixels take libpng's r == g == b branch
        img[::3, ::2, 1:3] = img[::3, ::2, :1]
    path = str(tmp_path_factory.mktemp("p") / "p.png")
    if channels == 2:
        rows = [b"\x00" + r.astype(">u2" if wide else np.uint8).tobytes()
                for r in img]
        with open(path, "wb") as f:
            f.write(_png(w, h, 4, 16 if wide else 8, rows))
    else:
        cv2.imwrite(path, img[..., 0] if channels == 1 else img,
                    [cv2.IMWRITE_PNG_STRATEGY, strategy])
    np.testing.assert_array_equal(
        imageio.imread_rgb(path), cv2.cvtColor(cv2.imread(path),
                                               cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(imageio.imread_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@SETTINGS
@given(h=st.integers(1, 300), w=st.integers(1, 300),
       out_h=st.integers(1, 300), out_w=st.integers(1, 300),
       channels=st.sampled_from([1, 3]), halve=st.booleans(),
       seed=st.integers(0, 99))
def test_resize_linear_matches_cv2(h, w, out_h, out_w, channels, halve, seed):
    """Includes exact halving, where cv2 switches to INTER_AREA."""
    if halve:
        h, w, out_h, out_w = 2 * out_h, 2 * out_w, out_h, out_w
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels),
                                               dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    want = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(imageio.resize_linear(img, (out_w, out_h)),
                                  want)


@SETTINGS
@given(h=st.integers(2, 260), w=st.integers(2, 260),
       out_h=st.integers(1, 260), out_w=st.integers(1, 260),
       angle=st.floats(-180, 180), scale=st.floats(0.3, 3.0),
       cx=st.floats(-50, 300), cy=st.floats(-50, 300),
       channels=st.sampled_from([1, 3]), seed=st.integers(0, 99))
def test_warp_affine_inverse_matches_cv2(h, w, out_h, out_w, angle, scale,
                                         cx, cy, channels, seed):
    """Rotations, scales and shifts that put the crop partly or wholly
    outside the image (border 0), at widths with and without a tail past
    the 16-pixel vector body."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w, channels),
                                               dtype=np.uint8)
    if channels == 1:
        img = img[..., 0]
    m = cv2.getRotationMatrix2D((cx, cy), angle, scale)
    want = cv2.warpAffine(img, m, (out_w, out_h),
                          flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                          borderValue=0)
    np.testing.assert_array_equal(
        imageio.warp_affine_inverse(img, m, (out_w, out_h)), want)


def _sof_patched(marker: int, precision: int = 8) -> bytes:
    buf = bytearray(cv2.imencode(".jpg", _image(1, 16, 16))[1].tobytes())
    at = buf.index(b"\xff\xc0")
    buf[at + 1] = marker
    buf[at + 4] = precision
    return bytes(buf)


@pytest.mark.parametrize("name,data,reason", [
    ("prog.jpg", lambda: cv2.imencode(
        ".jpg", _image(1, 16, 16), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1]
        .tobytes(), "progressive"),
    ("arith.jpg", lambda: _sof_patched(0xC9), "arithmetic"),
    ("lossless.jpg", lambda: _sof_patched(0xC3), "lossless"),
    ("deep.jpg", lambda: _sof_patched(0xC1, precision=12), "12-bit"),
    ("interlaced.png", lambda: _png(4, 4, 0, 8, [b"\0" * 5] * 4,
                                    interlace=1), "interlaced"),
    ("text.jpg", lambda: b"hello", "neither a JPEG nor a PNG"),
])
def test_refused_inputs_raise_naming_the_file(tmp_path, name, data, reason):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data())
    with pytest.raises(imageio.ImageDecodeError, match=reason) as exc:
        imageio.imread_rgb(path)
    assert name in str(exc.value)


@pytest.mark.parametrize("entry", [e for e in MANIFEST if e["file"] in (
    "hand_420_q95.jpg", "hand_rst_q95.jpg", "hand_rgb8.png",
    "hand_palette.png")], ids=lambda e: e["file"])
def test_corrupt_data_raises_or_decodes(entry):
    """Truncated or bit-flipped files give an image or an ImageDecodeError,
    never a crash or another error."""
    with open(entry["path"], "rb") as f:
        data = f.read()
    rng = np.random.default_rng(7)
    for t in range(60):
        b = bytearray(data)
        if t % 2:
            b = b[:int(rng.integers(2, len(b)))]
        else:
            for _ in range(int(rng.integers(1, 8))):
                b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
        try:
            img = imageio.imdecode_rgb(bytes(b))
        except imageio.ImageDecodeError:
            continue
        assert img.dtype == np.uint8 and img.ndim == 3


def test_missing_file_raises():
    with pytest.raises(FileNotFoundError):
        imageio.imread_rgb("/nonexistent/x.jpg")


def test_threads_decode_in_parallel_to_the_same_bytes():
    paths = [e["path"] for e in MANIFEST] * 4
    want = [imageio.imread_rgb(p) for p in paths]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(imageio.imread_rgb, paths))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_manifest_joints_lie_in_their_images():
    for e in MANIFEST:
        j = np.asarray(e["joints"])
        assert j.shape == (21, 2)
        h, w = e["shape"][:2]
        assert (j >= 0).all() and (j[:, 0] < w).all() and (j[:, 1] < h).all()


def test_manifest_was_made_by_the_generator():
    with open(os.path.join(chip_smoke.FIXTURES, "manifest.json")) as f:
        assert json.load(f)["cv2"]
    assert os.path.isfile(os.path.join(os.path.dirname(chip_smoke.FIXTURES),
                                       "make_images.py"))


def test_first_use_from_many_threads_builds_once(tmp_path, monkeypatch):
    """The Loader's threads may all reach the codec first at once: one
    builds the host library, all get the same loaded one."""
    from lighthand_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    calls, real = [], _build.build_all
    monkeypatch.setattr(_build, "build_all",
                        lambda names: calls.append(names) or real(names))
    with ThreadPoolExecutor(8) as pool:
        libs = list(pool.map(lambda _: _build.library("tsv_engine"),
                             range(8)))
    assert calls == [("tsv_engine",)]
    assert all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == [
        _build.library_path("tsv_engine").name]
