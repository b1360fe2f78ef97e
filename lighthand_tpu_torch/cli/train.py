"""Training CLI: counterpart of ``lighthand_tpu/cli/train.py``, with the
reference recipe surface (src/tools/train.py), e.g.

    python -m lighthand_tpu_torch.cli.train --root simplebaseline/ours \
        --name smoke --epoch 2 --count 5 --batch_size 32 --synthetic --yes

It runs on the card; ``--platform cpu`` runs the same program on the host.
Without a card and without that flag it raises.

Several GPUs: one process a GPU, e.g.

    torchrun --nproc-per-node 4 -m lighthand_tpu_torch.cli.train \
        --root hrnet/ours --name dp4 --mesh-data 4 --mesh-model 1 ...

or the ``LIGHTHAND_COORDINATOR`` / ``LIGHTHAND_NUM_PROCESSES`` /
``LIGHTHAND_PROCESS_ID`` variables (``core/dist.py``) set for each process.
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from lighthand_tpu_torch.config import parse_args
from lighthand_tpu_torch.core.dist import (
    maybe_initialize_distributed,
    shutdown,
)
from lighthand_tpu_torch.train.loop import train_from_config


def main(argv=None) -> int:
    cfg = parse_args(argv, phase="train")
    # a process group this call starts, it also ends
    started = not dist.is_initialized() and maybe_initialize_distributed(
        cfg.platform)
    try:
        result = train_from_config(cfg)
    finally:
        if started:
            shutdown()
    print(
        f"done: train_loss={result.train_loss:.6f} "
        f"val_loss={result.val_loss:.6f} pck={result.pck:.2f}% "
        f"epe={result.epe_px:.2f}px "
        f"throughput={result.images_per_sec:.1f} img/s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
