"""Write ``text_digests.json``: the SHA-256 of every caption of
``torch_fixtures.text_drawings`` made by the JAX package's ``draw_text`` and by
cv2's FontFace ``putText`` with the installed cv2, which the port's
``draw_text`` and ``put_text`` must reproduce bit for bit on any machine.

    JAX_PLATFORMS=cpu python tests/fixtures/make_text_digests.py

Needs cv2 5.0 (cv2 4.13 strokes Hershey glyphs instead) and the JAX
package. Regenerate only when the drawings change, never by hand.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))

import cv2  # noqa: E402

import torch_fixtures  # noqa: E402
from lighthand_tpu.utils import vis3d  # noqa: E402


def cv2_put_text(img, text, org, color, size, weight):
    """cv2 5.0's ``putText`` with ``FontFace("sans")``, in place; returns
    the pen's end as cv2 does."""
    pen, out = cv2.putText(img, text, org, color, cv2.FontFace("sans"),
                           size, weight)
    img[...] = out
    return tuple(pen)


def main() -> None:
    if not cv2.__version__.startswith("5."):
        raise SystemExit(f"needs cv2 5.x, found {cv2.__version__}")
    drawings = torch_fixtures.text_drawings(vis3d.draw_text, cv2_put_text)
    payload = {"cv2": cv2.__version__,
               "files": torch_fixtures.overlay_digests(drawings)}
    with open(os.path.join(HERE, "text_digests.json"), "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
