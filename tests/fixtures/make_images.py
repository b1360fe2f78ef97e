"""Regenerate the image fixtures of the port's codec and reader tests.

    python tests/fixtures/make_images.py      # needs cv2 (opencv-python)

Renders hands with the port's ``SyntheticHands``, encodes them with cv2 in
the kinds the datasets and the codec's edge cases need, and writes
``images/manifest.json``: for each file its joints (pixels of the decoded
image) and the SHA-256 of cv2's results: the RGB decode
(``IMREAD_COLOR`` + ``COLOR_BGR2RGB``), the gray decode
(``IMREAD_GRAYSCALE``), the decode resized to 256x256 (``INTER_LINEAR``)
and the decode warped by the file's ``warp`` matrix to 224x224
(``INTER_LINEAR | WARP_INVERSE_MAP``, border 0). The port is bit-exact on
all of them, so digests suffice.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from lighthand_tpu_torch.data.synthetic import SyntheticHands  # noqa: E402

OUT = os.path.join(HERE, "images")
SEED = 4242


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment whose EXIF IFD0 holds only the orientation tag."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def warp_matrix(i: int, w: int, h: int) -> list:
    """An output->input map that rotates, scales and shifts, as the
    FreiHAND crop does."""
    ang = np.deg2rad(17.0 + 23.0 * i)
    s = 0.8 + 0.05 * i
    cs, sn = np.cos(ang) * s, np.sin(ang) * s
    cx, cy = w / 2.0, h / 2.0
    return [[cs, -sn, cx - cs * 112 + sn * 112 + 3.5 * i],
            [sn, cs, cy - sn * 112 - cs * 112 - 2.25 * i]]


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    hands = SyntheticHands(length=16, size=224, seed=SEED)
    entries = []

    def jpeg(name, idx, params, *, size=None, gray=False, orientation=1):
        s = hands[idx]
        img, joints = s.image[..., ::-1].copy(), s.joints.copy()  # BGR
        if size is not None:  # (w, h)
            joints *= np.array([size[0] / 224.0, size[1] / 224.0], np.float32)
            img = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        stored = img
        if orientation == 6:  # shown = fliplr(stored^T)
            stored = np.ascontiguousarray(np.fliplr(img).swapaxes(0, 1))
        ok, buf = cv2.imencode(".jpg", stored, params)
        assert ok
        data = buf.tobytes()
        if orientation != 1:
            data = data[:2] + exif_app1(orientation) + data[2:]
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        entries.append({"file": name, "kind": "jpeg", "joints": joints})

    q = cv2.IMWRITE_JPEG_QUALITY
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    jpeg("hand_420_q95.jpg", 0, [q, 95, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
    jpeg("hand_444_q90.jpg", 1, [q, 90, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    jpeg("hand_422_q85.jpg", 2, [q, 85, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422])
    jpeg("hand_440_q80.jpg", 3, [q, 80, sf, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    jpeg("hand_gray_q90.jpg", 4, [q, 90], gray=True)
    jpeg("hand_rst_q95.jpg", 5, [q, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 5])
    jpeg("hand_ragged_97x131.jpg", 6, [q, 75], size=(97, 131))
    jpeg("hand_exif6.jpg", 7, [q, 92], orientation=6)

    def png(name, img_bgr, joints, kind="png"):
        ok, buf = cv2.imencode(".png", img_bgr, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        assert ok
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(buf.tobytes())
        entries.append({"file": name, "kind": kind, "joints": joints})

    s = hands[8]
    png("hand_rgb8.png", s.image[..., ::-1].copy(), s.joints)
    s = hands[9]
    small = cv2.resize(s.image[..., ::-1], (96, 96), interpolation=cv2.INTER_AREA)
    png("hand_rgb16.png", small.astype(np.uint16) * 257
        + np.arange(96, dtype=np.uint16)[None, :, None], s.joints * (96 / 224))
    # the mask of hand 8: the pixels its blue limbs lift above the render's
    # background, as RHD's segmentation masks mark the hand
    mask = (hands[8].image[..., 2] > 120).astype(np.uint8) * 200
    png("mask_gray.png", mask, hands[8].joints, kind="mask")
    # a palette PNG (cv2 writes none): 8-bit indices into 16 colours
    s = hands[10]
    small = cv2.resize(s.image, (64, 64), interpolation=cv2.INTER_AREA)
    idx = (small[..., 0] // 16).astype(np.uint8)
    pal = np.stack([np.arange(16) * 17, 255 - np.arange(16) * 17,
                    (np.arange(16) * 53) % 256], 1).astype(np.uint8)
    write_palette_png(os.path.join(OUT, "hand_palette.png"), idx, pal)
    entries.append({"file": "hand_palette.png", "kind": "png",
                    "joints": s.joints * (64 / 224)})

    for i, e in enumerate(entries):
        path = os.path.join(OUT, e["file"])
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        h, w = rgb.shape[:2]
        m = warp_matrix(i, w, h)
        e["joints"] = np.round(np.asarray(e["joints"], np.float64), 4).tolist()
        e["shape"] = list(rgb.shape)
        e["warp"] = m
        e["sha256"] = {
            "decode": digest(rgb),
            "gray": digest(cv2.imread(path, cv2.IMREAD_GRAYSCALE)),
            "resize256": digest(cv2.resize(rgb, (256, 256),
                                           interpolation=cv2.INTER_LINEAR)),
            "warp224": digest(cv2.warpAffine(
                rgb, np.asarray(m, np.float64), (224, 224),
                flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                borderValue=0)),
        }
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump({"cv2": cv2.__version__, "images": entries}, f, indent=1)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(entries)} images, {total} bytes")


def write_palette_png(path: str, idx: np.ndarray, pal: np.ndarray) -> None:
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    h, w = idx.shape
    # filter type 4 (Paeth) on every row
    rows = []
    prev = np.zeros(w, np.int32)
    for r in idx.astype(np.int32):
        out = np.empty(w, np.int32)
        for x in range(w):
            a = r[x - 1] if x else 0
            b = prev[x]
            c = prev[x - 1] if x else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[x] = (r[x] - pred) % 256
        rows.append(b"\x04" + out.astype(np.uint8).tobytes())
        prev = r
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", pal.tobytes())
            + chunk(b"IDAT", zlib.compress(b"".join(rows), 9))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


if __name__ == "__main__":
    main()
