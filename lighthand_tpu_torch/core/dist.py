"""Multi-process initialization: counterpart of ``lighthand_tpu/core/dist.py``.

The same environment contract, over ``torch.distributed``:

- ``LIGHTHAND_COORDINATOR`` = host:port of process 0, with
  ``LIGHTHAND_NUM_PROCESSES`` / ``LIGHTHAND_PROCESS_ID``: explicit wiring,
  ``init_process_group(init_method="tcp://host:port")``;
- ``LIGHTHAND_DIST=1``: ``init_method="env://"``, i.e. the ``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` (and ``LOCAL_RANK``)
  that ``torchrun`` sets.

With neither set nothing is initialised and the run is one process. The
backend is NCCL on the card and gloo on the CPU. Torch runs one process a
GPU (JAX one a host): a process's card is ``cuda:LOCAL_RANK``, where
``LOCAL_RANK`` defaults to the process id modulo the visible cards. A failed
initialisation raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def distributed_env_requested() -> bool:
    return bool(os.environ.get("LIGHTHAND_COORDINATOR")) or \
        os.environ.get("LIGHTHAND_DIST", "") in ("1", "true", "TRUE")


def _on_card(platform: str | None) -> bool:
    return platform != "cpu" and torch.cuda.is_available()


def local_rank() -> int:
    """This process's card index on its host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = int(os.environ.get("LIGHTHAND_PROCESS_ID",
                              os.environ.get("RANK", "0")))
    return rank % max(1, torch.cuda.device_count())


def maybe_initialize_distributed(platform: str | None = None) -> bool:
    """Initialise the process group the environment asks for, before any
    model or batch is placed. Returns True iff this process is part of a
    process group (world size 1 included)."""
    if dist.is_initialized():
        return True
    if not distributed_env_requested():
        return False
    backend = "nccl" if _on_card(platform) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    coord = os.environ.get("LIGHTHAND_COORDINATOR")
    if coord:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}",
            world_size=int(os.environ["LIGHTHAND_NUM_PROCESSES"]),
            rank=int(os.environ["LIGHTHAND_PROCESS_ID"]))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def process_device(platform: str | None = None) -> torch.device | None:
    """The device of this process in a process group: ``cuda:LOCAL_RANK``
    on the card, the CPU under ``--platform cpu``; None in one process
    (the caller's own choice then stands)."""
    if not dist.is_initialized():
        return None
    if platform == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", local_rank())


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
