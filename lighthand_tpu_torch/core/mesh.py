"""Device mesh: counterpart of ``lighthand_tpu/core/mesh.py``.

A 2-D ("data", "model") mesh over the processes of a ``torch.distributed``
run (``core/dist.py``): data-parallel over "data", the parameters sharded
over "model" by FSDP2 (``fully_shard`` over the 2-D mesh is HSDP: replicate
over data, shard over model).

- At model axis 1 the parameters are replicated, as ``param_sharding``
  replicates them there (``lighthand_tpu/core/mesh.py:81``): plain tensors
  in every process, broadcast once from data index 0, with the gradients
  averaged over the data axis after each backward (``average_gradients``,
  one flat all-reduce per dtype). No FSDP2 wrap, no per-parameter copies.

- ``MeshSpec.resolve`` keeps the JAX semantics and errors.
- Torch runs one process a device where JAX runs one a host, so the mesh
  must cover the world size exactly: a mesh that does not raises a
  ``ValueError`` naming the launch (``torchrun --nproc-per-node N``), and
  no run carries on over fewer devices.
- One process with no process group has no mesh (None): every helper
  below then gives the single-process answer.
- ``shard_dim`` is the port's copy of ``param_sharding``'s rule (the
  largest dim the model axis divides), given to FSDP2 as its
  ``shard_placement_fn``; a parameter with no such dim takes FSDP2's padded
  ``Shard(0)``. Where a shard sits changes the layout, not the numbers.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """#devices along the data (DP) and model (FSDP) axes."""

    data: int = -1  # -1 = all remaining devices
    model: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        model = max(1, self.model)
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(
                f"mesh {data}x{model} does not cover {n_devices} devices"
            )
        return MeshSpec(data=data, model=model)


def local_device_count() -> int:
    """CUDA devices this process sees (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_host_leader() -> bool:
    """Rank 0 (the reference's ``comm.is_main_process()``, comm.py:32)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def create_mesh(spec: MeshSpec | None, device: torch.device):
    """The ("data", "model") ``DeviceMesh`` over every process, or None in
    one process without a process group (which still checks ``spec``)."""
    spec = spec or MeshSpec()
    n = world_size()
    try:
        spec = spec.resolve(n)
    except ValueError as e:
        want = max(1, spec.data) * max(1, spec.model)
        raise ValueError(
            f"{e}: the port runs one process per device, and this run has "
            f"{n}; launch {want} with `torchrun --nproc-per-node {want} -m "
            "lighthand_tpu_torch.cli.train ...` or the LIGHTHAND_COORDINATOR "
            "/ LIGHTHAND_NUM_PROCESSES / LIGHTHAND_PROCESS_ID variables"
        ) from None
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device.type, (spec.data, spec.model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_index(mesh) -> tuple[int, int]:
    """(this process's index along the data axis, the axis's size): the
    row block of each global batch that it owns."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(DATA_AXIS), mesh.size(mesh_dim=0)


def data_group(mesh):
    """The process group of the data axis; None where it has one member."""
    if mesh is None or mesh.size(mesh_dim=0) == 1:
        return None
    return mesh.get_group(DATA_AXIS)


def shard_dim(shape, n_model: int) -> int | None:
    """``param_sharding``'s rule: the largest dim divisible by (and not
    smaller than) ``n_model``, the first of equals; None for a scalar, for
    ``n_model`` 1, or where no dim divides."""
    if n_model == 1 or len(shape) == 0:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n_model == 0 and d >= n_model:
            if best is None or d > shape[best]:
                best = i
    return best


def model_axis(mesh) -> int:
    """The model axis's size (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh_dim=1)


def replica_group(mesh):
    """The group over which a replicated model's gradients are averaged:
    the data group at model axis 1 (None where it has one member); None
    where the model axis is above 1, since FSDP2 reduces its own."""
    return data_group(mesh) if model_axis(mesh) == 1 else None


def _coalesced(tensors, fn) -> None:
    """``fn`` on one flat buffer per dtype of ``tensors``, the result copied
    back into each tensor (in its own memory format)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.detach())
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def average_gradients(params, group) -> None:
    """The gradients of ``params``, in place, averaged over ``group``: one
    summing all-reduce of a flat buffer per dtype (gloo has no average),
    then a division by the group's size."""
    n = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(n)

    _coalesced([p.grad for p in params if p.grad is not None], mean)


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``fully_shard`` ``model`` over the 2-D mesh (HSDP), each parameter
    on its ``shard_dim``, where the model axis is above 1. At model axis 1
    the model stays plain and replicated: its parameters and buffers are
    broadcast from data index 0, so the replicas cannot start apart. Call
    before the optimizer is built. The identity without a mesh."""
    if mesh is None:
        return model
    if model_axis(mesh) == 1:
        group = data_group(mesh)
        if group is not None:
            src = dist.get_global_rank(group, 0)
            _coalesced([*model.parameters(), *model.buffers()],
                       lambda flat: dist.broadcast(flat, src=src,
                                                   group=group))
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n_model = mesh.size(mesh_dim=1)

    def placement(param):
        dim = shard_dim(tuple(param.shape), n_model)
        return None if dim is None else Shard(dim)

    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    """Whether FSDP2 wraps ``model`` (only where the model axis is above
    1)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)
