"""Extract the Rubik font that OpenCV 5.0 draws ``putText`` with.

OpenCV 5.0 builds its fonts into its binary as gzip members, each named by
its file (``Rubik.ttf``, ``Rubik-Italic.ttf``). This script finds the
``Rubik.ttf`` member in the ``cv2`` extension module and writes it unpacked:

    python tools/extract_cv2_font.py \
        [--out lighthand_tpu_torch/fonts/Rubik.ttf] [--so PATH]

Without ``--so`` it imports ``cv2`` to find the module (it needs cv2 5.0).
``tests/test_torch_text.py`` holds the committed font to this script's
output byte for byte.
"""

from __future__ import annotations

import argparse
import pathlib
import zlib

NAME = "Rubik.ttf"


def find_member(blob: bytes) -> bytes:
    """The unpacked gzip member whose header names ``Rubik.ttf``. A gzip
    header with a file name is 10 bytes, then the name and a NUL."""
    key = NAME.encode() + b"\x00"
    at = blob.find(key)
    while at >= 0:
        start = at - 10
        if start >= 0 and blob[start:start + 3] == b"\x1f\x8b\x08":
            return zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(
                blob[start:])
        at = blob.find(key, at + 1)
    raise ValueError(f"no gzip member named {NAME!r}")


def cv2_module_path() -> pathlib.Path:
    import cv2  # only here: the port never imports cv2

    lib = pathlib.Path(cv2.__file__).parent
    found = sorted(lib.glob("cv2*.so")) + sorted(lib.glob("cv2*.pyd"))
    if not found:
        raise FileNotFoundError(f"no cv2 extension module under {lib}")
    return found[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "lighthand_tpu_torch"
                                         / "fonts" / NAME))
    ap.add_argument("--so", default=None,
                    help="the cv2 extension module (default: import cv2)")
    args = ap.parse_args(argv)
    so = pathlib.Path(args.so) if args.so else cv2_module_path()
    data = find_member(so.read_bytes())
    pathlib.Path(args.out).write_bytes(data)
    print(f"{args.out}: {len(data)} bytes from {so.name}")


if __name__ == "__main__":
    main()
