"""Training CLI: counterpart of ``lighthand_tpu/cli/train.py``, with the
reference recipe surface (src/tools/train.py), e.g.

    python -m lighthand_tpu_torch.cli.train --root simplebaseline/ours \
        --name smoke --epoch 2 --count 5 --batch_size 32 --synthetic --yes

It runs on the card; ``--platform cpu`` runs the same program on the host.
Without a card and without that flag it raises.
"""

from __future__ import annotations

import sys

from lighthand_tpu_torch.config import parse_args
from lighthand_tpu_torch.train.loop import train_from_config


def main(argv=None) -> int:
    cfg = parse_args(argv, phase="train")
    result = train_from_config(cfg)
    print(
        f"done: train_loss={result.train_loss:.6f} "
        f"val_loss={result.val_loss:.6f} pck={result.pck:.2f}% "
        f"epe={result.epe_px:.2f}px "
        f"throughput={result.images_per_sec:.1f} img/s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
