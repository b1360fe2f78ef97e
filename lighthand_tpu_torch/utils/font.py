"""A TrueType reader for the port's text: counterpart of what OpenCV 5.0's
``putText(img, text, org, color, FontFace("sans"), size, weight)`` reads.

OpenCV 5.0 draws its "sans" face, Rubik (``fonts/Rubik.ttf``, a variable
font with one axis, ``wght`` 300-900), through its copy of stb_truetype
extended for variable fonts. This module reads what that code reads, with
its integer arithmetic, so that ``utils/visualize.py:put_text`` draws cv2's
pixels:

- the tables: the sfnt directory, ``head``, ``hhea``, ``maxp``, ``loca``,
  ``glyf`` (simple and composite glyphs), ``cmap`` (formats 4 and 12; the
  last Microsoft-Unicode or Unicode record, as stb_truetype picks it),
  ``hmtx``, ``fvar``, ``avar`` and ``gvar``. ``HVAR``, ``MVAR`` and ``GPOS``
  are not read: cv2 reads none of them (it applies no kerning).
- the instance: a weight in 16.16 fixed point is clamped to the axis and
  normalised to F2Dot14 with rounding, ``((v - default) * 16384 + span / 2)
  // span``, then mapped through ``avar``'s segments with the same rounding.
- the deltas: each tuple's scalar is 16.16 (``0x10000 * coord // peak``,
  truncated); a point's delta adds ``(delta * scalar) >> 8`` into a 24.8
  sum, and the point moves by the sum ``>> 8`` (floor). Points a tuple does
  not name are interpolated (IUP) in integers from the original outline,
  ``(d_lo * (c_hi - c_lo) + (p - c_lo) * (d_hi - d_lo)) / (c_hi - c_lo)``
  truncated toward zero.
- the box and the advance: the glyph header's box, its corners moved by the
  phantom points' deltas (x0 by the origin's, x1 by the advance point's, y0
  by the top's, y1 by the bottom's); the advance is ``hmtx``'s plus the
  advance point's delta less the origin's.
- the outline: stb_truetype's ``GetGlyphShapeTT``: contours of move, line
  and quadratic-curve vertices in font units, an implied on-curve point
  between two off-curve points at ``(a + b) >> 1``; a composite's
  components transformed and cut to 16 bits as stb_truetype does.

The font is parsed once (``rubik()``); outlines are cached per (glyph,
weight). Nothing here imports cv2.
"""

from __future__ import annotations

import functools
import math
import pathlib
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

FONT_PATH = pathlib.Path(__file__).resolve().parents[1] / "fonts" / "Rubik.ttf"

MOVE, LINE, CURVE = 1, 2, 3  # stb_truetype's vertex types


class Outline(NamedTuple):
    """One glyph at one instance. ``vertices`` is int16 ``[n, 5]``: type,
    x, y, cx, cy (font units, y up); ``box`` is (x0, y0, x1, y1) and
    ``advance`` the advance width, both in font units."""

    vertices: np.ndarray
    box: Tuple[int, int, int, int]
    advance: int


def _s16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _idiv(a: int, b: int) -> int:
    """C integer division: truncation toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


class Font:
    """The tables of one TrueType font that ``put_text`` needs."""

    def __init__(self, data: bytes):
        self.data = data
        n_tables = self._u16(4)
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(n_tables):
            rec = 12 + 16 * i
            tag = data[rec:rec + 4].decode("latin-1")
            self.tables[tag] = (self._u32(rec + 8), self._u32(rec + 12))
        for tag in ("head", "hhea", "maxp", "loca", "glyf", "cmap", "hmtx"):
            if tag not in self.tables:
                raise ValueError(f"font has no {tag!r} table")
        head = self.tables["head"][0]
        self.units_per_em = self._u16(head + 18)
        self.long_loca = self._s16(head + 50) != 0
        self.num_glyphs = self._u16(self.tables["maxp"][0] + 4)
        hhea = self.tables["hhea"][0]
        self.ascent = self._s16(hhea + 4)
        self.descent = self._s16(hhea + 6)
        self.num_hmetrics = self._u16(hhea + 34)
        self.cmap = self._read_cmap()
        self.axes = self._read_fvar()
        self.avar = self._read_avar()
        self._gvar = self._read_gvar_header()

    def _u8(self, at: int) -> int:
        return self.data[at]

    def _s8(self, at: int) -> int:
        v = self.data[at]
        return v - 256 if v & 0x80 else v

    def _u16(self, at: int) -> int:
        return (self.data[at] << 8) | self.data[at + 1]

    def _s16(self, at: int) -> int:
        return _s16(self._u16(at))

    def _u32(self, at: int) -> int:
        return struct.unpack_from(">I", self.data, at)[0]

    def _s32(self, at: int) -> int:
        return struct.unpack_from(">i", self.data, at)[0]

    def _read_cmap(self) -> Dict[int, int]:
        base = self.tables["cmap"][0]
        sub = None
        for i in range(self._u16(base + 2)):
            rec = base + 4 + 8 * i
            platform, encoding = self._u16(rec), self._u16(rec + 2)
            if platform == 0 or (platform == 3 and encoding in (1, 10)):
                sub = base + self._u32(rec + 4)  # the last one wins
        if sub is None:
            raise ValueError("font has no Unicode cmap")
        fmt = self._u16(sub)
        table: Dict[int, int] = {}
        if fmt == 4:
            seg2 = self._u16(sub + 6)
            ends = sub + 14
            starts = ends + seg2 + 2
            deltas = starts + seg2
            ranges = deltas + seg2
            for s in range(seg2 // 2):
                end = self._u16(ends + 2 * s)
                start = self._u16(starts + 2 * s)
                delta = self._u16(deltas + 2 * s)
                roff = self._u16(ranges + 2 * s)
                for cp in range(start, min(end, 0xFFFE) + 1):
                    if roff == 0:
                        g = (cp + delta) & 0xFFFF
                    else:
                        g = self._u16(ranges + 2 * s + roff + 2 * (cp - start))
                        if g:
                            g = (g + delta) & 0xFFFF
                    if g:
                        table[cp] = g
        elif fmt == 12:
            for i in range(self._u32(sub + 12)):
                grp = sub + 16 + 12 * i
                start, end, g0 = (self._u32(grp), self._u32(grp + 4),
                                  self._u32(grp + 8))
                for cp in range(start, end + 1):
                    table[cp] = g0 + cp - start
        else:
            raise ValueError(f"cmap format {fmt} is not read")
        return table

    def glyph_index(self, codepoint: int) -> int:
        """The glyph of a code point, 0 (.notdef) where the font has none."""
        return self.cmap.get(codepoint, 0)

    def hmetrics(self, glyph: int) -> Tuple[int, int]:
        """(advance, left side bearing) from ``hmtx``, default instance."""
        base = self.tables["hmtx"][0]
        if glyph < self.num_hmetrics:
            return self._s16(base + 4 * glyph), self._s16(base + 4 * glyph + 2)
        adv = self._s16(base + 4 * (self.num_hmetrics - 1))
        lsb = self._s16(base + 4 * self.num_hmetrics
                        + 2 * (glyph - self.num_hmetrics))
        return adv, lsb

    def _glyf_range(self, glyph: int) -> Tuple[int, int]:
        loca = self.tables["loca"][0]
        if self.long_loca:
            a, b = self._u32(loca + 4 * glyph), self._u32(loca + 4 * glyph + 4)
        else:
            a, b = 2 * self._u16(loca + 2 * glyph), \
                2 * self._u16(loca + 2 * glyph + 2)
        g = self.tables["glyf"][0]
        return g + a, g + b

    def _read_fvar(self) -> List[Tuple[str, int, int, int]]:
        if "fvar" not in self.tables:
            return []
        base = self.tables["fvar"][0]
        axes_at = base + self._u16(base + 4)
        count, size = self._u16(base + 8), self._u16(base + 10)
        axes = []
        for i in range(count):
            a = axes_at + i * size
            axes.append((self.data[a:a + 4].decode("latin-1"),
                         self._s32(a + 4), self._s32(a + 8),
                         self._s32(a + 12)))
        return axes

    def _read_avar(self) -> List[List[Tuple[int, int]]]:
        if "avar" not in self.tables:
            return [[] for _ in self.axes]
        base = self.tables["avar"][0]
        at = base + 8
        maps = []
        for _ in range(self._u16(base + 6)):
            n = self._u16(at)
            maps.append([(self._s16(at + 2 + 4 * k), self._s16(at + 4 + 4 * k))
                         for k in range(n)])
            at += 2 + 4 * n
        return maps

    def normalized(self, weight: int) -> Tuple[int, ...]:
        """The F2Dot14 coordinates of ``wght = weight`` (other axes at their
        default), as cv2's setInstance computes them."""
        coords = []
        for i, (tag, lo, default, hi) in enumerate(self.axes):
            v = (int(weight) << 16) if tag == "wght" else default
            v = min(v, hi)
            if v < lo:
                v = lo
            if default > v:
                span = default - lo
                n = -((((default - v) << 14) + _idiv(span, 2)) // span)
            elif default < v:
                span = hi - default
                n = (((v - default) << 14) + _idiv(span, 2)) // span
            else:
                n = 0
            n = max(-16384, min(n, 16384 if default < hi else 0))
            coords.append(self._avar_map(i, n))
        return tuple(coords)

    def _avar_map(self, axis: int, v: int) -> int:
        seg = self.avar[axis] if axis < len(self.avar) else []
        if len(seg) < 2:
            return v
        for (f0, t0), (f1, t1) in zip(seg, seg[1:]):
            if f0 <= v < f1:
                return (((v - f0) * (t1 - t0) + ((f1 - f0) >> 1))
                        // (f1 - f0)) + t0
        if v == seg[-1][0]:
            return seg[-1][1]
        return v

    def _read_gvar_header(self):
        if "gvar" not in self.tables or not self.axes:
            return None
        base = self.tables["gvar"][0]
        axis_count = self._u16(base + 4)
        shared_count = self._u16(base + 6)
        shared_at = base + self._u32(base + 8)
        glyph_count = self._u16(base + 12)
        long_offsets = self._u16(base + 14) & 1
        data_at = base + self._u32(base + 16)
        shared = [tuple(self._s16(shared_at + 2 * (t * axis_count + a))
                        for a in range(axis_count))
                  for t in range(shared_count)]
        return dict(base=base, axis_count=axis_count, shared=shared,
                    glyph_count=glyph_count, long=long_offsets, data=data_at)

    def _variation_range(self, glyph: int) -> Optional[Tuple[int, int]]:
        g = self._gvar
        if g is None or glyph >= g["glyph_count"]:
            return None
        at = g["base"] + 20
        if g["long"]:
            a, b = self._u32(at + 4 * glyph), self._u32(at + 4 * glyph + 4)
        else:
            a = 2 * self._u16(at + 2 * glyph)
            b = 2 * self._u16(at + 2 * glyph + 2)
        if b <= a:
            return None
        return g["data"] + a, g["data"] + b

    def _read_points(self, at: int) -> Tuple[Optional[List[int]], int]:
        """Packed point numbers; ``None`` means every point."""
        count = self._u8(at)
        at += 1
        if count & 0x80:
            count = ((count & 0x7F) << 8) | self._u8(at)
            at += 1
        if count == 0:
            return None, at
        points, last = [], 0
        while len(points) < count:
            ctl = self._u8(at)
            at += 1
            run = (ctl & 0x7F) + 1
            for _ in range(run):
                if ctl & 0x80:
                    last = (last + self._u16(at)) & 0xFFFF
                    at += 2
                else:
                    last = (last + self._u8(at)) & 0xFFFF
                    at += 1
                points.append(last)
        return points[:count], at

    def _read_deltas(self, at: int, count: int) -> Tuple[List[int], int]:
        out: List[int] = []
        while len(out) < count:
            ctl = self._u8(at)
            at += 1
            run = (ctl & 0x3F) + 1
            if ctl & 0x80:
                out.extend([0] * run)
            elif ctl & 0x40:
                out.extend(self._s16(at + 2 * k) for k in range(run))
                at += 2 * run
            else:
                out.extend(self._s8(at + k) for k in range(run))
                at += run
        return out[:count], at

    @staticmethod
    def _scalar(coords, peak, start=None, end=None) -> int:
        """A tuple's 16.16 scalar at ``coords`` (0 where it does not apply)."""
        scalar = 0x10000
        for a, (c, p) in enumerate(zip(coords, peak)):
            if p == 0 or c == p:
                continue
            if start is None:
                if c == 0 or (c > 0) != (p > 0) or abs(c) > abs(p):
                    return 0
                scalar = _idiv(scalar * c, p)
            else:
                s, e = start[a], end[a]
                if c <= s or c >= e:
                    return 0
                if c < p:
                    scalar = _idiv(scalar * (c - s), p - s)
                else:
                    scalar = _idiv(scalar * (e - c), e - p)
        return scalar

    def _deltas(self, glyph: int, coords, original: np.ndarray,
                ends: List[int]) -> Optional[np.ndarray]:
        """The 24.8 delta sums of ``original`` (``[n + 4, 2]`` int points,
        the 4 phantom points last), or ``None`` without variation data.
        ``ends`` are the contours' last point indices (empty for a
        composite, whose points are its components)."""
        rng = self._variation_range(glyph)
        if rng is None or not any(coords):
            return None
        start, stop = rng
        g = self._gvar
        n_all = len(original)
        count_word = self._u16(start)
        n_tuples = count_word & 0x0FFF
        data = start + self._u16(start + 2)
        shared_points = None
        if count_word & 0x8000:
            shared_points, data = self._read_points(data)
        acc = np.zeros((n_all, 2), dtype=np.int64)
        hdr = start + 4
        ax = g["axis_count"]
        for _ in range(n_tuples):
            size = self._u16(hdr)
            index = self._u16(hdr + 2)
            hdr += 4
            if index & 0x8000:
                peak = tuple(self._s16(hdr + 2 * a) for a in range(ax))
                hdr += 2 * ax
            else:
                peak = g["shared"][index & 0x0FFF]
            s = e = None
            if index & 0x4000:
                s = tuple(self._s16(hdr + 2 * a) for a in range(ax))
                e = tuple(self._s16(hdr + 2 * ax + 2 * a) for a in range(ax))
                hdr += 4 * ax
            tuple_data, data = data, data + size
            scalar = self._scalar(coords, peak, s, e)
            if scalar == 0:
                continue
            at = tuple_data
            if index & 0x2000:
                points, at = self._read_points(at)
            else:
                points = shared_points
            n = n_all if points is None else len(points)
            dx, at = self._read_deltas(at, n)
            dy, at = self._read_deltas(at, n)
            if points is None:
                d = np.stack([dx, dy], axis=1).astype(np.int64)
            else:
                d = self._interpolate(original, ends, points, dx, dy)
            acc += (d * scalar) >> 8
        return acc

    @staticmethod
    def _interpolate(original: np.ndarray, ends: List[int], points, dx, dy):
        """The deltas of every point from those of ``points`` (IUP): named
        points keep theirs, the phantom points and the points of a contour
        with none named get 0, the rest are interpolated per contour
        between the named points before and after them (cyclically). cv2
        differs from the spec in one case: in a contour whose first point
        is not named, the points after the last named point take that
        point's delta."""
        n_all = len(original)
        d = np.zeros((n_all, 2), dtype=np.int64)
        touched = np.zeros(n_all, dtype=bool)
        for p, x, y in zip(points, dx, dy):
            if p < n_all:
                d[p] = (x, y)
                touched[p] = True
        first = 0
        for last in ends:
            idx = [i for i in range(first, last + 1) if touched[i]]
            if idx:
                # spans of untouched points and their two references; when
                # the contour's first point is untouched, cv2 takes the
                # last named point as both references after it
                spans = [(r1, r2, range(r1 + 1, r2))
                         for r1, r2 in zip(idx, idx[1:])]
                tail = idx[0] if idx[0] == first else idx[-1]
                spans.append((idx[-1], tail, range(idx[-1] + 1, last + 1)))
                spans.append((idx[-1], idx[0], range(first, idx[0])))
                for r1, r2, points_in in spans:
                    for i in points_in:
                        for a in (0, 1):
                            d[i, a] = Font._iup(
                                int(original[i, a]), int(original[r1, a]),
                                int(d[r1, a]), int(original[r2, a]),
                                int(d[r2, a]))
            first = last + 1
        return d

    @staticmethod
    def _iup(p: int, c1: int, d1: int, c2: int, d2: int) -> int:
        if c1 == c2:
            return d1 if d1 == d2 else 0
        if c1 > c2:
            c1, d1, c2, d2 = c2, d2, c1, d1
        if p <= c1:
            return d1
        if p >= c2:
            return d2
        return _idiv(d1 * (c2 - c1) + (p - c1) * (d2 - d1), c2 - c1)

    def outline(self, glyph: int, weight: int) -> Outline:
        return self._outline(glyph, self.normalized(weight))

    @functools.lru_cache(maxsize=4096)
    def _outline(self, glyph: int, coords: Tuple[int, ...]) -> Outline:
        if not 0 <= glyph < self.num_glyphs:
            raise ValueError(f"glyph {glyph} is not in the font's "
                             f"{self.num_glyphs}")
        g0, g1 = self._glyf_range(glyph)
        adv, lsb = self.hmetrics(glyph)
        if g1 <= g0:
            return Outline(np.zeros((0, 5), np.int16), (0, 0, 0, 0), adv)
        n_contours = self._s16(g0)
        box = [self._s16(g0 + 2), self._s16(g0 + 4), self._s16(g0 + 6),
               self._s16(g0 + 8)]
        phantom = np.array([[box[0] - lsb, 0], [box[0] - lsb + adv, 0],
                            [0, 0], [0, 0]], dtype=np.int64)
        if n_contours >= 0:
            verts, acc = self._simple(glyph, g0, n_contours, coords, phantom)
        else:
            verts, acc = self._composite(glyph, g0, coords, phantom)
        if acc is not None:
            p = acc[-4:] >> 8
            box = [box[0] + int(p[0, 0]), box[1] + int(p[2, 1]),
                   box[2] + int(p[1, 0]), box[3] + int(p[3, 1])]
            adv = adv + int(p[1, 0]) - int(p[0, 0])
        return Outline(np.asarray(verts, dtype=np.int16).reshape(-1, 5),
                       tuple(box), adv)

    def _simple(self, glyph, g0, n_contours, coords, phantom):
        ends = [self._u16(g0 + 10 + 2 * i) for i in range(n_contours)]
        if n_contours == 0:
            return [], None
        n = ends[-1] + 1
        at = g0 + 10 + 2 * n_contours
        at += 2 + self._u16(at)  # instructions
        flags = []
        while len(flags) < n:
            f = self._u8(at)
            at += 1
            flags.append(f)
            if f & 8:
                flags.extend([f] * self._u8(at))
                at += 1
        flags = flags[:n]
        pts = np.zeros((n, 2), dtype=np.int64)
        for axis, short, same in ((0, 2, 16), (1, 4, 32)):
            v = 0
            for i, f in enumerate(flags):
                if f & short:
                    dv = self._u8(at)
                    at += 1
                    v += dv if f & same else -dv
                elif not f & same:
                    v += self._s16(at)
                    at += 2
                v = _s16(v)
                pts[i, axis] = v
        original = np.concatenate([pts, phantom])
        acc = self._deltas(glyph, coords, original, ends)
        if acc is not None:  # int16 wrap, as the points are stored
            pts = ((pts + (acc[:n] >> 8) + 0x8000) & 0xFFFF) - 0x8000
        return _tt_vertices(pts.tolist(), flags, ends), acc

    def _composite(self, glyph, g0, coords, phantom):
        comps = []
        at = g0 + 10
        while True:
            flags, gidx = self._u16(at), self._u16(at + 2)
            at += 4
            if flags & 1:
                a, b = self._s16(at), self._s16(at + 2)
                at += 4
            else:
                a, b = self._s8(at), self._s8(at + 1)
                at += 2
            if not flags & 2:
                # stb_truetype does not place such components either, and
                # no glyph of Rubik has one (a test reads every glyph)
                raise ValueError(f"glyph {glyph}: a component placed by "
                                 "matching points is not read")
            mtx = [1.0, 0.0, 0.0, 1.0]
            if flags & 8:
                mtx[0] = mtx[3] = self._s16(at) / 16384.0
                at += 2
            elif flags & 0x40:
                mtx[0], mtx[3] = self._s16(at) / 16384.0, \
                    self._s16(at + 2) / 16384.0
                at += 4
            elif flags & 0x80:
                mtx = [self._s16(at + 2 * k) / 16384.0 for k in range(4)]
                at += 8
            comps.append([gidx, a, b, mtx])
            if not flags & 0x20:
                break
        original = np.concatenate([
            np.array([[c[1], c[2]] for c in comps], dtype=np.int64), phantom])
        acc = self._deltas(glyph, coords, original, [])
        if acc is not None:
            for c, d in zip(comps, (acc[:len(comps)] >> 8).tolist()):
                c[1] = _s16(c[1] + d[0])
                c[2] = _s16(c[2] + d[1])
        out = []
        for gidx, dx, dy, mtx in comps:
            sub = self._outline(gidx, coords).vertices.astype(np.int64)
            out.extend(_transform(sub, mtx, dx, dy))
        return out, acc


def _f32(v) -> np.float32:
    return np.float32(v)


def _transform(verts: np.ndarray, mtx, dx: int, dy: int):
    """stb_truetype's component transform, in f32: ``m * (a*x + c*y + e)``
    cut toward zero to 16 bits (m, n the column norms)."""
    m0, m1, m2, m3 = (_f32(v) for v in mtx)
    e, f = _f32(dx), _f32(dy)
    m = _f32(math.sqrt(float(m0 * m0 + m1 * m1)))
    n = _f32(math.sqrt(float(m2 * m2 + m3 * m3)))
    out = []
    for t, x, y, cx, cy in verts.tolist():
        row = [t]
        for px, py in ((x, y), (cx, cy)):
            fx, fy = _f32(px), _f32(py)
            row.append(_s16(int(m * (m0 * fx + m2 * fy + e))))
            row.append(_s16(int(n * (m1 * fx + m3 * fy + f))))
        out.append(row)
    return out


def _tt_vertices(pts, flags, ends):
    """stb_truetype's ``GetGlyphShapeTT`` from points to vertices."""
    out = []
    n = len(pts)
    sx = sy = cx = cy = scx = scy = 0
    was_off = start_off = 0
    next_move = 0
    j = 0

    def close():
        if start_off:
            if was_off:
                out.append([CURVE, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy])
            out.append([CURVE, sx, sy, scx, scy])
        elif was_off:
            out.append([CURVE, sx, sy, cx, cy])
        else:
            out.append([LINE, sx, sy, 0, 0])

    i = 0
    while i < n:
        f = flags[i]
        x, y = pts[i]
        if next_move == i:
            if i != 0:
                close()
            start_off = not f & 1
            if start_off:
                scx, scy = x, y
                if not flags[i + 1] & 1:
                    sx = (x + pts[i + 1][0]) >> 1
                    sy = (y + pts[i + 1][1]) >> 1
                else:
                    sx, sy = pts[i + 1]
                    i += 1
            else:
                sx, sy = x, y
            out.append([MOVE, sx, sy, 0, 0])
            was_off = 0
            next_move = 1 + ends[j]
            j += 1
        elif not f & 1:
            if was_off:
                out.append([CURVE, (cx + x) >> 1, (cy + y) >> 1, cx, cy])
            cx, cy = x, y
            was_off = 1
        else:
            out.append([CURVE, x, y, cx, cy] if was_off
                       else [LINE, x, y, 0, 0])
            was_off = 0
        i += 1
    close()
    return out


@functools.lru_cache(maxsize=None)
def rubik() -> Font:
    """The font cv2 5.0's ``FontFace("sans")`` draws, parsed once."""
    return Font(FONT_PATH.read_bytes())
