"""Write ``overlay_digests.json``: the SHA-256 of every drawing of
``torch_fixtures.overlay_drawings`` made by the JAX package's landmark and
skeleton overlays and by cv2's line, circle and arrow with the installed
cv2, which the port must reproduce bit for bit on any machine.

    JAX_PLATFORMS=cpu python tests/fixtures/make_overlay_digests.py

Needs cv2 (the digests were made with cv2 5.0.0) and the JAX package.
Regenerate only when the drawings change, never by hand.
"""

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))

import cv2  # noqa: E402

import torch_fixtures  # noqa: E402
from lighthand_tpu.utils import landmarks, vis3d  # noqa: E402


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        drawings = torch_fixtures.overlay_drawings(
            lambda img, a, b, c, t: cv2.line(img, a, b, c, t),
            lambda img, o, r, c, t: cv2.circle(img, o, r, c, t),
            lambda img, a, b, c, t: cv2.arrowedLine(img, a, b, c, t),
            landmarks, vis3d, tmp)
    payload = {"cv2": cv2.__version__,
               "files": torch_fixtures.overlay_digests(drawings)}
    with open(os.path.join(HERE, "overlay_digests.json"), "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
