"""Parallelism surface: counterpart of ``lighthand_tpu/parallel/__init__.py``.

  create_mesh / MeshSpec   ("data", "model") DeviceMesh over the processes
  shard_model              FSDP2 (HSDP) over the mesh, each parameter on
                           ``shard_dim`` (``param_sharding``'s rule), where
                           the model axis is above 1; replication at 1
  is_host_leader           rank-0 gating (comm.is_main_process)
  all_gather_metrics       every process's host values, on every process
"""

from __future__ import annotations

import torch.distributed as dist

from lighthand_tpu_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    create_mesh,
    data_group,
    data_index,
    is_host_leader,
    shard_dim,
    shard_model,
)


def all_gather_metrics(tree) -> list:
    """[tree of rank 0, tree of rank 1, ...] on every process (the
    reference's pickle all_gather, comm.py:104-144, as
    ``all_gather_object``); ``[tree]`` in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [tree]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, tree)
    return out


__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "MeshSpec",
    "all_gather_metrics",
    "create_mesh",
    "data_group",
    "data_index",
    "is_host_leader",
    "shard_dim",
    "shard_model",
]
