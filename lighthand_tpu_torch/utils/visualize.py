"""Prediction / GT overlays: counterpart of ``lighthand_tpu/utils/visualize.py``.

Reference: visualize_gt/visualize_pred (src/utils/visualize.py:10-64): 21
joints and 20 bones over the denormalized image, saved to
``{output_dir}/{train,val,eval}_image/{epoch}_epoch/iter_N.jpg``.

The JAX package draws with OpenCV; the port draws the same pixels in numpy,
on the host:

- a joint is ``cv2.circle(img, (x, y), 2, (255, 255, 255), -1)``: OpenCV's
  integer midpoint circle, filled with one horizontal span per row, each
  span cut to the image;
- a bone is ``cv2.line(img, p0, p1, color, 1)`` (8-connected): the line is
  first cut to the image by ``cv2.clipLine``'s arithmetic (the second end
  moved along the line through the first end's moved position, the cuts
  truncated toward zero), then walked from its left end by OpenCV's
  ``LineIterator``, which takes ``dx + 1`` steps along the major axis;
- joints are cast with ``int()`` (truncation toward zero).

The thick primitives of ``utils/landmarks.py`` and ``utils/vis3d.py`` follow
OpenCV's ``drawing.cpp`` in 16-bit sub-pixel units (``XY_SHIFT``):

- ``cv2.line`` with thickness t > 1 first cuts the segment to the image
  grown by t on every side (``clipLine`` of that rectangle), then is
  ``ThickLine``: the segment widened by
  ``cvRound`` of the half-width along its normal into a 4-point polygon,
  filled by ``FillConvexPoly`` (its edges first drawn by ``Line2``, then
  spans between two edges stepped by a rounded slope), and a filled circle
  of radius ``(t + 1) // 2`` at each end;
- ``cv2.circle`` as an outline: thickness 1 is the midpoint circle's eight
  points; above 1 it is ``EllipseEx``: the points of ``ellipse2Poly`` (its
  sine table is ``sin`` of whole degrees at 7 decimals, in f32), a step of
  90, 30, 18 or 5 degrees by radius, drawn as thick segments with a cap
  only at each segment's end after the first;
- ``cv2.arrowedLine`` is the shaft and two tip lines from ``cvRound`` ends
  at the shaft's angle (``atan2``) +- pi/4, a tenth of its length long.

``save_overlay`` writes the JPEG with the port's encoder
(``data/imageio.py:imwrite_rgb``, cv2's bytes at quality 95).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import unicodedata
from typing import Optional

import numpy as np
import torch

from lighthand_tpu_torch.data.imageio import imwrite_rgb
from lighthand_tpu_torch.ops.color import denormalize_imagenet
from lighthand_tpu_torch.ops.kernels import _build
from lighthand_tpu_torch.utils import font

# parents array (visualize.py:15)
PARENTS = np.array(
    [-1, 0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19]
)

_FINGER_COLORS = [(255, 80, 80), (80, 255, 80), (80, 80, 255),
                  (255, 255, 80), (255, 80, 255)]


def _hline(img: np.ndarray, y: int, x0: int, x1: int, color) -> None:
    h, w = img.shape[:2]
    x0, x1 = max(x0, 0), min(x1, w - 1)
    if 0 <= y < h and x0 <= x1:
        img[y, x0:x1 + 1] = color


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` in place."""
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y in (cy - dy, cy + dy):
            _hline(img, y, cx - dx, cx + dx, color)
        for y in (cy - dx, cy + dx):
            _hline(img, y, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _cut(a: int, num: int, den: int) -> int:
    """``(int64)((double)a * num / den)``: truncation toward zero."""
    return int(float(a) * float(num) / float(den))


def clip_line(w: int, h: int, p1, p2):
    """``cv2.clipLine((0, 0, w, h), p1, p2)``: the ends moved into the
    image, or None where the line misses it."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _cut(a - y1, x2 - x1, y2 - y1)
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _cut(a - y2, x2 - x1, y2 - y1)
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _cut(a - x1, y2 - y1, x2 - x1)
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _cut(a - x2, y2 - y1, x2 - x1)
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return (x1, y1), (x2, y2)


def draw_line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """``cv2.line(img, p1, p2, color, thickness)`` (LINE_8) in place."""
    h, w = img.shape[:2]
    if thickness > 1:
        # cut first to the image grown by the thickness on every side
        t = thickness
        clipped = clip_line(w + 2 * t, h + 2 * t, (p1[0] + t, p1[1] + t),
                            (p2[0] + t, p2[1] + t))
        if clipped is not None:
            (x1, y1), (x2, y2) = clipped
            _thick_line(img, ((x1 - t) << XY_SHIFT, (y1 - t) << XY_SHIFT),
                        ((x2 - t) << XY_SHIFT, (y2 - t) << XY_SHIFT), color,
                        thickness, 3)
        return
    clipped = clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:  # walked from the left end
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:  # a step along both axes
            err += 2 * dx - 2 * dy
            x += sx
            y += sy
        else:  # a step along the major axis
            err -= 2 * dy
            if vert:
                y += sy
            else:
                x += sx


XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of 0..450 whole degrees, rounded to 7 decimals, f32
_SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7)
                       for d in range(451)], np.float32).astype(np.float64)


def _cv_round(x: float) -> int:
    """``cvRound``: to the nearest integer, ties to even."""
    return int(round(x))


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: a LINE_8 line between two points in ``XY_SHIFT``
    units, cut to the image (``clipLine`` in those units), stepped along
    its major axis with a truncated sub-pixel slope."""
    h, w = img.shape[:2]
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _div0(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _div0(dx << XY_SHIFT, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1


def _div0(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex_poly(img: np.ndarray, v, color) -> None:
    """OpenCV's ``FillConvexPoly`` (LINE_8, ``XY_SHIFT`` units): the edges
    drawn by ``_line2``, then one span a row between the left and right
    edge, each edge's x stepped by its rounded slope from its upper end."""
    h, w = img.shape[:2]
    n = len(v)
    delta = XY_ONE >> 1
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = ys.index(min(ys))
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    # [idx, di, x, dx, ye] of the two edges walked from the top vertex
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _div0((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs0
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + di) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = ((1, 0) if edge[0][2] > edge[1][2] else (0, 1))
            x1 = (edge[left][2] + delta) >> XY_SHIFT
            x2 = (edge[right][2] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, color, thickness: int,
                flags: int) -> None:
    """OpenCV's ``ThickLine`` for thickness > 1 (``XY_SHIFT`` units): the
    4-point polygon, then a filled circle at ``p0`` where ``flags & 1`` and
    at ``p1`` where ``flags & 2``."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex_poly(img, [(p0[0] + ddx, p0[1] + ddy),
                                (p0[0] - ddx, p0[1] - ddy),
                                (p1[0] - ddx, p1[1] - ddy),
                                (p1[0] + ddx, p1[1] + ddy)], color)
    radius = (half + (XY_ONE >> 1)) >> XY_SHIFT
    for bit, p in ((1, p0), (2, p1)):
        if flags & bit:
            fill_circle(img, ((p[0] + (XY_ONE >> 1)) >> XY_SHIFT,
                              (p[1] + (XY_ONE >> 1)) >> XY_SHIFT),
                        radius, color)


def _outline_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, 1)``: the midpoint circle's
    eight points, each drawn where it lies in the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for x, y in ((cx - dx, cy - dy), (cx + dx, cy - dy),
                     (cx - dx, cy + dy), (cx + dx, cy + dy),
                     (cx - dy, cy - dx), (cx + dy, cy - dx),
                     (cx - dy, cy + dx), (cx + dy, cy + dx)):
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _circle_poly(center, radius: int):
    """``EllipseEx``'s points of a whole circle in ``XY_SHIFT`` units:
    ``ellipse2Poly`` at a step set by the radius, rounded, consecutive
    repeats dropped."""
    cx, cy = center[0] << XY_SHIFT, center[1] << XY_SHIFT
    axis = radius << XY_SHIFT
    r = (axis + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if r < 3 else 30 if r < 10 else 18 if r < 15 else 5
    pts = []
    for deg in range(0, 360 + step, step):
        deg = min(deg, 360)
        x = cx + axis * _SIN_TABLE[450 - deg]
        y = cy + axis * _SIN_TABLE[deg]
        p = (_cv_round(x), _cv_round(y))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    return pts


def draw_circle(img: np.ndarray, center, radius: int, color,
                thickness: int = 1) -> None:
    """``cv2.circle(img, center, radius, color, thickness)`` (LINE_8) in
    place: filled for a negative thickness."""
    if thickness < 0:
        fill_circle(img, center, radius, color)
    elif thickness <= 1:
        _outline_circle(img, center, radius, color)
    else:
        pts = _circle_poly(center, radius)
        flags = 3
        for a, b in zip(pts[:-1], pts[1:]):
            _thick_line(img, a, b, color, thickness, flags)
            flags = 2


def draw_arrowed_line(img: np.ndarray, p1, p2, color, thickness: int = 1,
                      tip_length: float = 0.1) -> None:
    """``cv2.arrowedLine(img, p1, p2, color, thickness)`` in place."""
    tip = math.sqrt(float(p1[0] - p2[0]) ** 2 + float(p1[1] - p2[1]) ** 2
                    ) * tip_length
    draw_line(img, p1, p2, color, thickness)
    angle = math.atan2(float(p1[1] - p2[1]), float(p1[0] - p2[0]))
    for a in (angle + math.pi / 4, angle - math.pi / 4):
        p = (_cv_round(p2[0] + tip * math.cos(a)),
             _cv_round(p2[1] + tip * math.sin(a)))
        draw_line(img, p, p2, color, thickness)


@functools.lru_cache(maxsize=None)
def _text_lib() -> ctypes.CDLL:
    lib = _build.library("text")
    lib.lh_text_box.argtypes = [ctypes.c_int] * 4 + [ctypes.c_float,
                                                     ctypes.c_void_p]
    lib.lh_text_box.restype = None
    lib.lh_text_rasterize.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.lh_text_rasterize.restype = ctypes.c_int
    lib.lh_text_blend.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.lh_text_blend.restype = None
    return lib


@functools.lru_cache(maxsize=4096)
def _glyph_mask(glyph: int, weight: int, size: int):
    """(coverage, dx, dy, advance in pixels) of one glyph: the coverage's
    top-left pixel lies at (pen + dx, baseline + dy)."""
    face = font.rubik()
    outline = face.outline(glyph, weight)
    scale = np.float32(size) / np.float32(face.ascent)
    advance = int(np.rint(np.float32(64.0) * (np.float32(outline.advance)
                                              * scale))) >> 6
    if len(outline.vertices) == 0:
        return None, 0, 0, advance
    lib = _text_lib()
    box = np.zeros(5, dtype=np.int32)
    lib.lh_text_box(*outline.box, float(scale), box.ctypes.data)
    ix0, iy0, w, h, margin = box.tolist()
    mask = np.empty((h + 2 * margin, w + 2 * margin), dtype=np.uint8)
    verts = np.ascontiguousarray(outline.vertices, dtype=np.int16)
    if lib.lh_text_rasterize(verts.ctypes.data, len(verts), float(scale),
                             ix0, iy0, w, h, margin, mask.ctypes.data):
        raise ValueError(f"glyph {glyph}: its outline does not start with "
                         "a move")
    return mask, ix0 - margin, iy0 - margin, advance


def _check_codepoint(face, ch: str) -> int:
    cp = ord(ch)
    if unicodedata.category(ch)[0] == "C":
        raise ValueError(f"put_text draws no control or format character "
                         f"(U+{cp:04X})")
    if unicodedata.bidirectional(ch) in ("R", "AL"):
        raise ValueError(f"put_text does not lay out right-to-left text "
                         f"(U+{cp:04X} {ch!r})")
    glyph = face.glyph_index(cp)
    if glyph == 0:
        raise ValueError(f"U+{cp:04X} {ch!r} is not in Rubik; cv2 draws it "
                         "from a font the repository does not hold")
    return glyph


def put_text(img_u8: np.ndarray, text: str, org, color, size: int = 11,
             weight: int = 400):
    """``cv2.putText(img, text, org, color, cv2.FontFace("sans"), size,
    weight)`` of cv2 5.0 in place: Rubik at ``size`` pixels (the font's
    ascent), ``weight`` 100-1000 (clamped to the font's 300-900),
    anti-aliased. ``org`` is the pen's start on the baseline. Returns the
    pen's position after the text, as cv2 does; from ``org.x >= W`` cv2
    draws nothing and returns ``org``.

    ``img_u8`` is uint8 [H, W, 3] with packed pixels; ``color`` three
    0-255 integers (a fourth is ignored, as cv2 does on three channels). A
    glyph is placed at whole pixels: the pen moves by its advance rounded to
    1/64 pixel, then cut to a whole pixel. A code point Rubik lacks, a
    control character and right-to-left text raise ``ValueError`` (cv2 draws
    the first from another built-in font and lays out the others)."""
    img = img_u8
    if (img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3
            or img.strides[1:] != (3, 1)):
        raise ValueError("put_text draws into a packed uint8 [H, W, 3] image")
    height, width = img.shape[:2]
    if int(size) < 1:
        raise ValueError(f"size {size} is not a positive pixel size")
    col = [int(c) for c in color][:4]
    if any(c < 0 or c > 255 for c in col):
        raise ValueError(f"color {color} is not 0-255 a channel")
    col = np.array((col + [0] * 3)[:3], dtype=np.uint8)
    face = font.rubik()
    glyphs = [_check_codepoint(face, ch) for ch in text]
    weight = int(weight)
    x, y = int(org[0]), int(org[1])
    if x >= width:  # cv2 draws nothing from right of the image
        return x, y
    for glyph in glyphs:
        mask, dx, dy, advance = _glyph_mask(glyph, weight, int(size))
        if mask is not None:
            _text_lib().lh_text_blend(
                img.ctypes.data, height, width, img.strides[0],
                mask.ctypes.data, mask.shape[0], mask.shape[1], x + dx,
                y + dy, col.ctypes.data)
        x += advance
    return x, y


def draw_joints(image_u8: np.ndarray, joints: np.ndarray) -> np.ndarray:
    """The skeleton over a copy of ``image_u8`` (uint8 [H, W, 3])."""
    img = np.ascontiguousarray(np.array(image_u8, copy=True))
    joints = np.asarray(joints)[:, :2]
    for j in range(21):
        x, y = int(joints[j, 0]), int(joints[j, 1])
        fill_circle(img, (x, y), 2, (255, 255, 255))
        p = PARENTS[j]
        if p >= 0:
            color = _FINGER_COLORS[(j - 1) // 4 % 5]
            px, py = int(joints[p, 0]), int(joints[p, 1])
            draw_line(img, (px, py), (x, y), color)
    return img


def save_overlay(
    normalized_image: np.ndarray,
    gt_joints: Optional[np.ndarray],
    pred_joints: Optional[np.ndarray],
    output_dir: str,
    phase: str,
    epoch: int,
    iteration: int,
) -> str:
    """Write the GT | prediction overlay of the ImageNet-normalized HWC float
    image (one panel where one of the two is None) to
    ``{output_dir}/{phase}_image/{epoch}_epoch/iter_{iteration}.jpg``;
    returns the path. The image is denormalized in f32, then
    ``clip(x * 255, 0, 255)`` and truncated, as the JAX package does."""
    img = denormalize_imagenet(torch.as_tensor(np.asarray(normalized_image)))
    img = np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8)
    panels = []
    if gt_joints is not None:
        panels.append(draw_joints(img, gt_joints))
    if pred_joints is not None:
        panels.append(draw_joints(img, pred_joints))
    canvas = np.concatenate(panels, axis=1) if len(panels) > 1 else panels[0]

    out_dir = os.path.join(output_dir, f"{phase}_image", f"{epoch}_epoch")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"iter_{iteration}.jpg")
    imwrite_rgb(path, canvas)
    return path
