"""Write ``make_synth_digests.json``: the SHA-256 of every file of the
trees the JAX package's tree-making CLIs write (with the installed cv2),
which the port must reproduce byte for byte:

- ``make_synth_data``: ``lighthand_tpu.cli.make_synth_data`` with
  ``torch_fixtures.SYNTH_ARGS``;
- ``make_lighthand``: ``lighthand_tpu.cli.make_lighthand.process_split``
  (seed 9001) over ``torch_fixtures.write_armhand_tree``'s capture tree.

JSON files are hashed with the output root replaced by ``{out}``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_digests.py

Needs jax and cv2 (the digests were made with cv2 5.0.0). Regenerate only
when the generators change, never by hand.
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
from lighthand_tpu.cli import make_lighthand, make_synth_data  # noqa: E402


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        synth = os.path.join(tmp, "synth")
        make_synth_data.main(["--out", synth, *torch_fixtures.SYNTH_ARGS])
        raw, out = os.path.join(tmp, "armhand"), os.path.join(tmp, "lh")
        phase = torch_fixtures.write_armhand_tree(raw)
        make_lighthand.process_split(raw, out, phase, 224, 9001)
        digests = torch_fixtures.tree_digests
        payload = {"cv2": cv2.__version__,
                   "make_synth_data": {
                       "args": list(torch_fixtures.SYNTH_ARGS),
                       "files": digests(synth)},
                   "make_lighthand": {"seed": 9001, "files": digests(out)}}
    with open(os.path.join(HERE, "make_synth_digests.json"), "w") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
