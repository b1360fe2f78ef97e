"""The port's data-parallel x FSDP path (``core/dist.py``, ``core/mesh.py``,
``parallel``, global BatchNorm, the process-sharded ``Loader``, the eval
reductions and gathers, rank-0 checkpoints) on the CPU, in gloo processes
launched through the environment contract (``LIGHTHAND_COORDINATOR`` /
``LIGHTHAND_NUM_PROCESSES`` / ``LIGHTHAND_PROCESS_ID``), as
``tests/test_multiprocess.py`` rehearses the JAX package's.

Each child runs this file as a script (it imports no JAX): on its mesh it
holds the ``hrnet_tiny`` fused train step against the single-process step
on the same global batch, which it also runs, and writes what it measured.
The JAX package's pjit step is one logical program, so the mesh must give
the one-process numbers (measured at 64x64, global batch 8, lr 1e-4, on the
meshes with 2 data indices; on (1, 2), whose processes each hold the whole
batch, every gap is 0):

- the gradients of one ``flip`` + ``rot_deg`` chain step, before Adam, in
  f64: the worst leaf's max error over its max within 1e-9 (measured
  1.4e-13). f32 cannot hold such a bound: there the worst leaf (in the
  stem and ``layer1``) differs by 6.9e-2, as much as the two BatchNorm
  formulas (global and local) differ by in one f32 process;
- two Adam steps over the shards (``train/state.py:ShardAdam``) given the
  same seeded gradients as the plain model's: every parameter and moment
  equal, bit for bit;
- then three f32 Adam steps (two on the K1 route, one chain step; jitter on
  half the rows): each loss within 5e-3 relative, the JAX package's bound
  (``__graft_entry__.py:156-161``; measured 2.1e-7, 3.0e-5, 6.6e-5); the
  update (the parameters less their start, its norm over the whole model)
  within 0.2 of the one-process update (measured 5.8e-2: Adam's first
  steps are about lr * sign(g), and f32 flips the sign of gradients near
  0); the running statistics within 5e-3 (measured 4.5e-4).

At model axis 1 the model is replicated, as the JAX package's
``param_sharding`` replicates it there: plain parameters, broadcast from
data index 0 at setup, the gradients averaged over the data axis by one
flat all-reduce per dtype after backward (``core/mesh.py``); above 1, FSDP2
shards it (HSDP). Two faults, each planted in a copy of the port, fail
these checks on the (2, 1) mesh (measured on the replicated route):

- no gradient all-reduce over the data axis: gradients 3.51, update 1.02,
  loss at steps 2 and 3 3.1e-2 and 5.9e-2, running statistics 6.1e-2, and
  the replicas part (rank 1's resumed parameters differ from rank 0's);
- BatchNorm normalised per process: gradients 2.65, update 1.27, loss at
  step 1 9.9e-3, running statistics 8.2e-2.

In the Trainer case (2 x 1, resnet18) the update of rank 0's checkpoint
is within 1.4e-2 of one process's; with those faults Loss/train is 1.9e-2
and 5.2e-3 off one process's (bound 5e-3).
This mesh equals the one-process port; the one-process port equals the JAX
step (``tests/test_torch_step.py``), which equals JAX's pjit step
(``tests/test_sharding.py``).

Under the int8_fwd policy on the FSDP2 meshes (model axis 2), the root's
forward quantizes the weights in one grouped call, and FSDP2's pre-forward
hook hands that call the unsharded parameters (plain tensors of the full
shapes): two K1 steps' losses within 5e-3 of one process's (measured 0.0
on (1, 2), whose processes each hold the whole batch).

The larger meshes are rehearsed only here: the card's machine has one GPU.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lighthand_tpu_torch.core.mesh import MeshSpec, shard_dim
from lighthand_tpu_torch.parallel import all_gather_metrics

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
MESHES = [(2, 1), (1, 2), (2, 2)]
MESH_IDS = ["2x1", "1x2", "2x2"]
LR = 1e-4
STEPS = 3
B, SIZE, HM = 8, 64, 16
LOSS_RTOL = 5e-3
GRAD_RTOL = 1e-9
UPDATE_RTOL = 0.2
STAT_ATOL = 5e-3
EVAL_RTOL = 1e-5  # of each eval sum (measured up to 3e-7: the weights differ)
CHILD_TIMEOUT = 240
FROZEN = r"^(conv1|bn1|conv2|bn2|layer1)\."  # a fine-tune's frozen stem


# ------------------------------------------------------------- the child


def _global_batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=(B, SIZE, SIZE, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            6, SIZE - 6, size=(B, 21, 2)).astype(np.float32)),
        "aug_enabled": torch.from_numpy((np.arange(B) % 2)
                                        .astype(np.float32)),
        "noise_enabled": torch.from_numpy((np.arange(B) % 4 == 1)
                                          .astype(np.float32)),
    }


class _Rows:
    """A Source whose sample i carries i in its joints."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def getitems(self, indices):
        from lighthand_tpu_torch.data.records import Sample

        return [Sample(image=np.full((4, 4, 3), i, np.uint8),
                       joints=np.full((21, 2), i, np.float32))
                for i in indices]


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _grad_err(sharded, ref) -> float:
    """The worst leaf's max |mesh gradient - one-process gradient| over its
    max |one-process gradient|: what the last step reduced, before Adam."""
    worst = 0.0
    for p, q in zip(sharded.model.parameters(), ref.model.parameters()):
        got, want = _full(p.grad), q.grad
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
    return worst


def _update_err(sharded, ref, start) -> float:
    """|mesh update - one-process update| over |one-process update|, the
    norms taken over every parameter: the steps since ``start``."""
    diff = norm = 0.0
    for p, q, p0 in zip(sharded.model.parameters(), ref.model.parameters(),
                        start):
        want = q.detach() - p0
        diff += float(((_full(p.detach()) - p0) - want).square().sum())
        norm += float(want.square().sum())
    return (diff / norm) ** 0.5


def _adam_err(ref, sharded) -> float:
    """Two Adam steps of the sharded state (``ShardAdam`` over the local
    shards) and of the plain one, given the same seeded gradients: the
    largest |difference| of any parameter or moment, whole. Asserts that
    the tensors the update is given are plain ones."""
    from torch.distributed.tensor import distribute_tensor

    gen = torch.Generator().manual_seed(11)
    for _ in range(2):
        for p, q in zip(sharded.model.parameters(), ref.model.parameters()):
            g = torch.randn(q.shape, generator=gen, dtype=q.dtype)
            q.grad = g
            p.grad = (distribute_tensor(g, p.device_mesh, p.placements)
                      if hasattr(p, "device_mesh") else g.clone())
        ref.optimizer.step()
        sharded.optimizer.step()
    # the update itself runs over plain tensors, not per-op DTensor dispatch
    lists = [[] for _ in range(6)]
    sharded.optimizer._init_group(sharded.optimizer.param_groups[0], *lists)
    assert lists[0] and all(type(t) in (torch.Tensor, torch.nn.Parameter)
                            for seq in lists[:4] for t in seq)
    worst = 0.0
    for p, q in zip(sharded.model.parameters(), ref.model.parameters()):
        pairs = [(p.detach(), q.detach())] + [
            (sharded.optimizer.state[p][k], ref.optimizer.state[q][k])
            for k in ("exp_avg", "exp_avg_sq")]
        for got, want in pairs:
            worst = max(worst, float((_full(got) - want).abs().max()))
    return worst


def _wrap(state, mesh, m: int, rank: int) -> dict:
    """How ``create_train_state`` holds the model on the mesh: whether
    FSDP2 wraps it, the types of its parameters, and (at model axis 1)
    whether the replicas equal rank 0's after setup, each process having
    drawn its weights from its own seed."""
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule

    st = state(mesh, seed=rank)
    params = list(st.model.parameters())
    out = {"fsdp": isinstance(st.model, FSDPModule),
           "param_types": sorted({type(p.data).__name__ for p in params}),
           "grad_group": st.grad_group is not None}
    if m == 1:
        flat = torch.cat([t.detach().reshape(-1) for t in
                          [*params, *st.model.buffers()]
                          if t.is_floating_point()])
        every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(every, flat)
        out["replicas_equal"] = all(torch.equal(x, every[0]) for x in every)
    return out


def _int8_gaps(mesh, batch, local) -> dict:
    """Two int8_fwd K1 steps of ``hrnet_tiny`` on the mesh and in one
    process: the relative loss gaps, and what each grouped quantize call of
    the mesh's forwards was given (parameter types and shapes)."""
    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.ops import quant
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_fused_train_step,
    )

    def state(mesh_):
        return create_train_state(
            get_model("hrnet_tiny", policy=DTypePolicy.int8_fwd()),
            torch.Generator().manual_seed(0), lr=LR, device="cpu",
            mesh=mesh_)

    kw = dict(heatmap_size=HM, device="cpu")
    ref, sharded = state(None), state(mesh)
    full = [tuple(m.weight.shape) for m in ref.model.quant_convs]
    calls = []
    grouped = quant.quantize_weights_cuda

    def spy(ws, act_clip):
        calls.append(([type(w).__name__ for w in ws],
                      [tuple(w.shape) for w in ws]))
        return grouped(ws, act_clip)

    gaps = []
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    for _ in range(2):
        _, want = make_fused_train_step(**kw)(ref, gens[0], batch)
        quant.quantize_weights_cuda = spy
        try:
            _, got = make_fused_train_step(**kw, mesh=mesh)(
                sharded, gens[1], local)
        finally:
            quant.quantize_weights_cuda = grouped
        want, got = float(want["loss"]), float(got["loss"])
        gaps.append(abs(got - want) / abs(want))
    return {"loss_gaps": gaps, "calls": len(calls),
            "types": sorted({t for types, _ in calls for t in types}),
            "full_shapes": all(shapes == full for _, shapes in calls)}


def _child(d: int, m: int, out_dir: str) -> None:
    """One process of a ``d`` x ``m`` mesh: every check raises on a
    mismatch; rank 0 writes the measured gaps and the gathered state."""
    import torch.distributed as dist

    from lighthand_tpu_torch.core.dist import maybe_initialize_distributed
    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.core.mesh import (
        create_mesh,
        data_index,
        is_host_leader,
        is_sharded,
    )
    from lighthand_tpu_torch.data import Loader
    from lighthand_tpu_torch.eval.harness import _gather_rows
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_fused_train_step,
    )
    from lighthand_tpu_torch.train.checkpoint import (
        resume_checkpoint,
        save_checkpoint,
    )

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == d * m
    rank = dist.get_rank()
    cpu = torch.device("cpu")
    mesh = create_mesh(MeshSpec(d, m), cpu)
    index, count = data_index(mesh)
    assert count == d and is_host_leader() == (rank == 0)
    per = B // d
    rows = slice(index * per, (index + 1) * per)

    def state(mesh_, dtype=torch.float32, seed=0):
        policy = DTypePolicy(param_dtype=dtype, compute_dtype=dtype,
                             output_dtype=dtype)
        model = get_model("hrnet_tiny", policy=policy)
        return create_train_state(model.to(dtype),
                                  torch.Generator().manual_seed(seed),
                                  lr=LR, device=cpu, mesh=mesh_)

    batch = _global_batch()
    local = {k: v[rows] for k, v in batch.items()}
    chain = {"flip": True, "rot_deg": 15.0}

    # one chain step's gradients, before Adam, in f64: in f32 the rounding
    # alone moves the worst hrnet_tiny leaf by 7e-2 and would hide a fault
    ref, sharded = state(None, torch.float64), state(mesh, torch.float64)
    kw = dict(heatmap_size=HM, compute_dtype=torch.float64, device=cpu)
    make_fused_train_step(**kw, **chain)(
        ref, torch.Generator().manual_seed(5), batch)
    make_fused_train_step(**kw, **chain, mesh=mesh)(
        sharded, torch.Generator().manual_seed(5), local)
    grad_err = _grad_err(sharded, ref)
    assert grad_err <= GRAD_RTOL, grad_err

    adam_err = _adam_err(state(None, torch.float64),
                         state(mesh, torch.float64))
    assert adam_err == 0.0, adam_err

    wrap = _wrap(state, mesh, m, rank)
    ref, sharded = state(None), state(mesh)
    assert is_sharded(sharded.model) == (m > 1) and not is_sharded(ref.model)
    start = [q.detach().clone() for q in ref.model.parameters()]
    kw = dict(heatmap_size=HM, compute_dtype=torch.float32, device=cpu)
    routes = [{}, {}, chain]
    gaps = []
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    for route in routes:
        _, want = make_fused_train_step(**kw, **route)(ref, gens[0], batch)
        _, got = make_fused_train_step(**kw, **route, mesh=mesh)(
            sharded, gens[1], local)
        want, got = float(want["loss"]), float(got["loss"])
        gaps.append(abs(got - want) / abs(want))
        assert gaps[-1] <= LOSS_RTOL, (route, got, want)

    update_err = _update_err(sharded, ref, start)
    stat_err = 0.0
    gathered = {name: _full(p.detach()).clone()
                for name, p in sharded.model.named_parameters()}
    for (name, b), c in zip(sharded.model.named_buffers(),
                            ref.model.buffers()):
        gathered[name] = b.clone()
        if name.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, float((b - c).abs().max()))
        else:
            assert torch.equal(b, c), name
    assert update_err <= UPDATE_RTOL and stat_err <= STAT_ATOL, (
        update_err, stat_err)

    # the eval step's pairs, summed over the data axis, are the batch's
    # (the one-process model given the mesh's weights)
    ref.model.load_state_dict(gathered)
    images = torch.randn(B, SIZE, SIZE, 3, generator=torch.Generator()
                         .manual_seed(1))
    valid = torch.tensor([1.0] * 6 + [0.0] * 2)
    eval_batch = {"image": images, "joints": batch["joints"], "valid": valid}
    want = make_eval_step(heatmap_size=HM, device=cpu)(ref, eval_batch)
    got = make_eval_step(heatmap_size=HM, device=cpu, mesh=mesh)(
        sharded, {k: v[rows] for k, v in eval_batch.items()})
    eval_err = {}
    for k in ("loss", "loss_sum", "n_valid", "pck", "pck_sum", "pck_count",
              "epe_sum", "epe_count"):
        eval_err[k] = (abs(float(got[k]) - float(want[k]))
                       / max(1.0, abs(float(want[k]))))
        assert eval_err[k] <= EVAL_RTOL, (k, got[k], want[k])
    assert float(got["n_valid"]) == 6.0

    # the Loader: each process its rows of the global order; the ragged
    # tail padded, ``valid`` sliced with the rows; gathered back in order
    for shuffle, drop_last, n in ((True, True, 12), (False, False, 10)):
        one = Loader(_Rows(n), 4, device=cpu, shuffle=shuffle,
                     drop_last=drop_last, num_workers=1)
        mine = Loader(_Rows(n), 4, device=cpu, shuffle=shuffle,
                      drop_last=drop_last, num_workers=1, mesh=mesh)
        assert len(mine) == len(one)
        k = 4 // d
        sl = slice(index * k, (index + 1) * k)
        ids, valids = [], []
        for a, b in zip(one, mine):
            assert torch.equal(b["joints"], a["joints"][sl])
            assert torch.equal(b["valid"], a["valid"][sl])
            ids.append(b["joints"][:, 0, 0].numpy())
            valids.append(b["valid"].numpy())
        back = _gather_rows({"id": np.concatenate(ids),
                             "valid": np.concatenate(valids)}, mesh, k)
        whole = [a for a in one]
        assert np.array_equal(back["id"], np.concatenate(
            [a["joints"][:, 0, 0].numpy() for a in whole]))
        assert np.array_equal(back["valid"], np.concatenate(
            [a["valid"].numpy() for a in whole]))
        if not drop_last:
            assert back["valid"].tolist()[-2:] == [0.0, 0.0]
    try:
        Loader(_Rows(8), 3, device=cpu, mesh=mesh)
        assert d == 1, "a batch the data axis does not divide must raise"
    except ValueError:
        assert d > 1

    assert all_gather_metrics({"rank": rank}) == [
        {"rank": r} for r in range(d * m)]

    # a rank-0 checkpoint of the gathered state; every rank resumes it
    run = os.path.join(out_dir, "run")
    save_checkpoint(sharded, run, 0, 0.5, 1,
                    model_info={"name": "hrnet_tiny", "precision": "f32"})
    optim = {name: {k: _full(v).clone() for k, v in
                    sharded.optimizer.state[p].items()}
             for name, p in sharded.model.named_parameters()}
    fresh = state(mesh)
    best, start, fresh, cnt = resume_checkpoint(fresh, run)
    assert (best, start, cnt, fresh.step) == (0.5, 1, 1, STEPS)
    for (name, p), q in zip(fresh.model.named_parameters(),
                            sharded.model.parameters()):
        assert torch.equal(_full(p.detach()), _full(q.detach())), name
        for k, v in fresh.optimizer.state[p].items():
            assert torch.equal(_full(v), optim[name][k]), (name, k)
    # fine-tuning with the stem and layer1 frozen: FSDP2 (model axis 2)
    # takes frozen and trainable parameters in one module; one step's loss
    # and update as one process's, the frozen parameters bit-equal
    from lighthand_tpu_torch.utils.misc import freeze_mask

    def frozen_state(mesh_):
        model = get_model("hrnet_tiny", policy=DTypePolicy(
            param_dtype=torch.float32, compute_dtype=torch.float32,
            output_dtype=torch.float32))
        return create_train_state(
            model, torch.Generator().manual_seed(0), lr=LR, device=cpu,
            mesh=mesh_, trainable=freeze_mask(model, [FROZEN]))

    fref, fmesh = frozen_state(None), frozen_state(mesh)
    fstart = [_full(p.detach()).clone() for p in fmesh.model.parameters()]
    _, want = make_fused_train_step(**kw)(
        fref, torch.Generator().manual_seed(5), batch)
    _, got = make_fused_train_step(**kw, mesh=mesh)(
        fmesh, torch.Generator().manual_seed(5), local)
    n_frozen = 0
    for p, p0 in zip(fmesh.model.parameters(), fstart):
        if p.requires_grad:
            assert not torch.equal(_full(p.detach()), p0)
        else:
            n_frozen += 1
            assert p.grad is None and torch.equal(_full(p.detach()), p0)
    frozen = {"n_frozen": n_frozen,
              "loss_gap": abs(float(got["loss"]) - float(want["loss"]))
              / abs(float(want["loss"])),
              "update_err": _update_err(fmesh, fref, fstart)}
    # int8_fwd under FSDP2: the grouped quantize sees whole weights
    int8 = _int8_gaps(mesh, batch, local) if (d, m) == (1, 2) else None
    if rank == 0:
        torch.save({"model": gathered, "optimizer": optim},
                   os.path.join(out_dir, "gathered.pt"))
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump({"wrap": wrap, "loss_gaps": gaps, "grad_err": grad_err,
                       "adam_err": adam_err,
                       "update_err": update_err,
                       "stat_err": stat_err, "eval_err": eval_err,
                       "frozen": frozen, "int8": int8}, f)
    dist.barrier()
    dist.destroy_process_group()


def _trainer_cfg(root: str):
    """A tiny Trainer run (resnet18, 32x32, 16 + 8 synthetic samples,
    batch 8, 2 epochs, f32), jitter on half the samples and the flip and
    rotation route on."""
    from lighthand_tpu_torch.config import Config

    cfg = Config(name="resnet18/ours/mesh", root_path=root)
    cfg.model.name, cfg.model.precision = "resnet18", "f32"
    cfg.data.dataset, cfg.data.synthetic = "ours", True
    cfg.data.image_size, cfg.data.heatmap_size = 32, 8
    cfg.data.batch_size, cfg.data.num_our = 8, 16
    cfg.data.num_workers, cfg.data.ratio_of_aug = 1, 0.5
    cfg.train.epochs, cfg.train.lr = 2, LR
    cfg.train.flip, cfg.train.rot_aug = True, 10.0
    cfg.train.visualize = False
    cfg.output_dir = os.path.join(root, cfg.name)
    cfg.tensorboard_dir = os.path.join(root, "tb")
    cfg.platform = "cpu"
    return cfg


def _child_trainer(out_dir: str) -> None:
    """One process of a 2 x 1 Trainer run (``train_from_config``)."""
    import torch.distributed as dist

    from lighthand_tpu_torch.core.dist import maybe_initialize_distributed
    from lighthand_tpu_torch.train.loop import Trainer

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu")
    cfg = _trainer_cfg(out_dir)
    cfg.mesh.data, cfg.mesh.model = 2, 1
    trainer = Trainer(cfg)
    assert trainer.describe_mesh() == (
        "{'data': 2, 'model': 1} over gloo, model sharded False")
    trainer.fit()
    if dist.get_rank() != 0:  # rank 0 alone logs and writes
        assert trainer.writer._jsonl is None
        assert all(isinstance(h, __import__("logging").NullHandler)
                   for h in trainer.logger.handlers)
    dist.barrier()
    dist.destroy_process_group()


def _child_overlay(out_dir: str) -> None:
    """One process of a 2 x 1 Trainer run with overlays on, 1 epoch: each
    process counts its predict steps and its overlay draws."""
    import torch.distributed as dist

    from lighthand_tpu_torch.core.dist import maybe_initialize_distributed
    from lighthand_tpu_torch.train import loop

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("cpu")
    cfg = _trainer_cfg(out_dir)
    cfg.mesh.data, cfg.mesh.model = 2, 1
    cfg.train.epochs, cfg.train.visualize = 1, True
    calls = {"predict": 0, "draw": 0}
    draw = loop.save_overlay

    def counted_draw(*args):
        calls["draw"] += 1
        return draw(*args)

    loop.save_overlay = counted_draw
    trainer = loop.Trainer(cfg)
    predict = trainer.predict_step

    def counted_predict(*args):
        calls["predict"] += 1
        return predict(*args)

    trainer.predict_step = counted_predict
    trainer.fit()
    with open(os.path.join(out_dir, f"calls{dist.get_rank()}.json"),
              "w") as f:
        json.dump(calls, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------ the parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(d: int, m: int, out_dir: str, mode: str = "step"):
    port = _free_port()
    procs = []
    for rank in range(d * m):
        env = dict(os.environ,
                   LIGHTHAND_COORDINATOR=f"localhost:{port}",
                   LIGHTHAND_NUM_PROCESSES=str(d * m),
                   LIGHTHAND_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, HERE, mode, str(d), str(m), out_dir], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's processes, launched together: {mesh: (exit codes,
    output, out_dir)}."""
    launched = {}
    for d, m in MESHES:
        out = str(tmp_path_factory.mktemp(f"mesh{d}x{m}"))
        launched[d, m] = (_launch(d, m, out), out)
    for mode in ("trainer", "overlay"):
        out = str(tmp_path_factory.mktemp(mode))
        launched[mode] = (_launch(2, 1, out, mode), out)
    done = {}
    for mesh, (procs, out) in launched.items():
        rcs, text = [], []
        for p in procs:
            try:
                stdout, _ = p.communicate(timeout=CHILD_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                stdout, _ = p.communicate()
            rcs.append(p.returncode)
            text.append(stdout)
        done[mesh] = (rcs, "\n".join(text), out)
    return done


def _result(runs, mesh):
    rcs, text, out = runs[mesh]
    assert rcs == [0] * len(rcs), text[-4000:]
    with open(os.path.join(out, "result.json")) as f:
        return json.load(f), out


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_train_step_matches_one_process(runs, mesh):
    """The f64 gradients of a chain step, then the loss (K1 route twice,
    then the flip + rotation chain), the update and the BatchNorm running
    statistics of the sharded steps against the single-process steps on
    the same global batch."""
    res, _ = _result(runs, mesh)
    assert len(res["loss_gaps"]) == STEPS
    assert max(res["loss_gaps"]) <= LOSS_RTOL
    assert res["grad_err"] <= GRAD_RTOL
    assert res["update_err"] <= UPDATE_RTOL
    assert res["stat_err"] <= STAT_ATOL


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_replicates_at_model_axis_1(runs, mesh):
    """At model axis 1 the model is replicated as ``param_sharding``
    replicates it (``lighthand_tpu/core/mesh.py:81``): no FSDP2 wrap, plain
    parameters, the gradients averaged by the steps (``grad_group``), and
    replicas equal after setup though each process drew its own weights.
    Where the model axis is above 1, FSDP2 shards it into DTensors."""
    res, _ = _result(runs, mesh)
    wrap = res["wrap"]
    if mesh[1] == 1:
        assert wrap == {"fsdp": False, "param_types": ["Tensor"],
                        "grad_group": mesh[0] > 1, "replicas_equal": True}
    else:
        assert wrap == {"fsdp": True, "param_types": ["DTensor"],
                        "grad_group": False}


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_adam_step_equals_plain(runs, mesh):
    """Adam over the local shards of a sharded model (``ShardAdam``) and
    over the whole parameters of a plain one, given the same gradients for
    two steps: every parameter and moment equal, bit for bit."""
    res, _ = _result(runs, mesh)
    assert res["adam_err"] == 0.0


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_fine_tunes_with_frozen_parameters(runs, mesh):
    """A ``freeze_mask`` state (``masked_optimizer``) on the mesh, FSDP2's
    included: the 45 frozen parameters of hrnet_tiny's stem and layer1
    keep their values and hold no gradient, the others move (checked in
    each child), and the step's loss and update are one process's."""
    res, _ = _result(runs, mesh)
    assert res["frozen"]["n_frozen"] == 45
    assert res["frozen"]["loss_gap"] <= LOSS_RTOL
    assert res["frozen"]["update_err"] <= UPDATE_RTOL


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_eval_sums_loader_rows_and_gathers(runs, mesh):
    """The eval step's (sum, count) pairs reduced over the data axis, the
    Loader's rows and ragged-tail ``valid`` per process, the gathered rows
    in the one-process order and ``all_gather_metrics`` (checked in each
    child)."""
    res, _ = _result(runs, mesh)
    assert max(res["eval_err"].values()) <= EVAL_RTOL


def test_fsdp_int8_step_matches_one_process(runs):
    """int8_fwd on the (1, 2) FSDP2 mesh: each forward makes one grouped
    quantize call, given the unsharded weights (no DTensor, the full
    shapes, as FSDP2's pre-forward hook gives the root's forward), and two
    steps' losses equal one process's within 5e-3."""
    res, _ = _result(runs, (1, 2))
    int8 = res["int8"]
    assert int8["calls"] == 2 and int8["full_shapes"], int8
    assert "DTensor" not in int8["types"], int8
    assert max(int8["loss_gaps"]) <= LOSS_RTOL, int8


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_mesh_checkpoint_loads_in_one_process(runs, mesh):
    """Rank 0's checkpoint of a sharded run loads into one process (and
    into ``cli.eval``'s path, ``load_weights_only``) equal to the state the
    mesh gathered."""
    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model
    from lighthand_tpu_torch.train import create_train_state
    from lighthand_tpu_torch.train.checkpoint import (
        load_weights_only,
        read_model_info,
        resume_checkpoint,
    )

    _, out = _result(runs, mesh)
    want = torch.load(os.path.join(out, "gathered.pt"), weights_only=True)
    state = create_train_state(
        get_model("hrnet_tiny", policy=DTypePolicy.full_precision()),
        lr=LR, device="cpu")
    best, start, state, count = resume_checkpoint(state, os.path.join(
        out, "run"))
    assert (best, start, count, state.step) == (0.5, 1, 1, STEPS)
    got = state.model.state_dict()
    assert sorted(got) == sorted(want["model"])
    for k, v in want["model"].items():
        assert torch.equal(got[k], v), k
    for name, p in state.model.named_parameters():
        for k, v in want["optimizer"][name].items():
            assert torch.equal(state.optimizer.state[p][k], v), (name, k)
    again = load_weights_only(create_train_state(
        get_model("hrnet_tiny"), device="cpu"),
        os.path.join(out, "run", "checkpoint-good"))
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, want["model"][k]), k
    assert read_model_info(os.path.join(out, "run", "checkpoint-good")) == {
        "name": "hrnet_tiny", "precision": "f32"}


def test_trainer_on_two_processes_matches_one(runs, tmp_path):
    """The Trainer (Loader rows, flip + rotation steps, eval sums, rank-0
    scalars and checkpoint) on a 2 x 1 mesh against one process on the
    same config: per-epoch Loss/train and Loss/valid within 5e-3 relative,
    and rank 0's checkpoint (the best epoch's) resumes in one process at
    the one-process run's epoch and step, its update since the seeded start
    within 0.2 of the one-process run's."""
    from lighthand_tpu_torch.train.loop import Trainer

    rcs, text, out = runs["trainer"]
    assert rcs == [0, 0], text[-4000:]
    one = Trainer(_trainer_cfg(str(tmp_path)))
    one.fit()

    def scalars(root, tag):
        path = os.path.join(root, "resnet18", "ours", "mesh", "scalars.jsonl")
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        return {r["step"]: r["value"] for r in rows if r["tag"] == tag}

    for tag in ("Loss/train", "Loss/valid"):
        got, want = scalars(out, tag), scalars(str(tmp_path), tag)
        assert sorted(got) == sorted(want) == [0, 1]
        for epoch in (0, 1):
            np.testing.assert_allclose(got[epoch], want[epoch],
                                       rtol=LOSS_RTOL, err_msg=tag)
    resumed = Trainer(_trainer_cfg(out))
    again = Trainer(_trainer_cfg(str(tmp_path)))
    assert resumed.start_epoch == again.start_epoch >= 1
    assert resumed.state.step == again.state.step >= 2
    start = [p.detach() for p in
             Trainer(_trainer_cfg(str(tmp_path / "init"))).state.model
             .parameters()]
    assert _update_err(resumed.state, again.state, start) <= UPDATE_RTOL


# ------------------------------------------------ rules, one process


def test_mesh_trainer_overlays_predict_everywhere_and_draw_on_rank_0(runs):
    """A 2 x 1 Trainer epoch with overlays on: both processes run the
    predict step at the train iterations {0, 1} (the sharded forward
    gathers, so rank 0 alone would hang), and rank 0 alone draws and writes
    the train and val overlays."""
    rcs, text, out = runs["overlay"]
    assert rcs == [0, 0], text[-4000:]
    calls = [json.load(open(os.path.join(out, f"calls{r}.json")))
             for r in range(2)]
    assert calls == [{"predict": 2, "draw": 3}, {"predict": 2, "draw": 0}]
    run = os.path.join(out, "resnet18", "ours", "mesh")
    jpgs = sorted(os.path.relpath(os.path.join(d, f), run)
                  for d, _, fs in os.walk(run) for f in fs
                  if f.endswith(".jpg"))
    assert jpgs == [os.path.join("train_image", "0_epoch", "iter_0.jpg"),
                    os.path.join("train_image", "0_epoch", "iter_1.jpg"),
                    os.path.join("val_image", "0_epoch", "iter_0.jpg")]


def _jax_resolve(spec, n):
    from lighthand_tpu.core.mesh import MeshSpec as JaxSpec

    try:
        return JaxSpec(spec.data, spec.model).resolve(n), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_mesh_spec_resolve_matches_jax(n):
    for data in (-1, 0, 1, 2, 3, 4, 8):
        for model in (-1, 0, 1, 2, 3, 4):
            spec = MeshSpec(data, model)
            want, err = _jax_resolve(spec, n)
            if err is None:
                got = spec.resolve(n)
                assert (got.data, got.model) == (want.data, want.model)
            else:
                with pytest.raises(ValueError) as info:
                    spec.resolve(n)
                assert str(info.value) == err


@pytest.mark.parametrize("n_model", [1, 2, 3, 4, 8])
def test_shard_dim_is_param_sharding_rule(n_model):
    """The shard dim of every hrnet_tiny parameter shape against the JAX
    package's ``param_sharding`` on an n_model-device model axis."""
    import jax

    from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
    from lighthand_tpu.core.mesh import MeshSpec as JaxSpec
    from lighthand_tpu.core.mesh import create_mesh, param_sharding
    from lighthand_tpu.models import get_model as jax_get_model
    from lighthand_tpu.train import create_train_state as jax_create_state

    jstate = jax_create_state(
        jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision()),
        jax.random.PRNGKey(0), input_shape=(1, 32, 32, 3))
    mesh = create_mesh(JaxSpec(data=1, model=n_model),
                       devices=jax.devices()[:n_model])
    leaves = jax.tree_util.tree_leaves(jstate.params)
    shapes = {tuple(x.shape) for x in leaves} | {(), (5,), (3, 6, 9)}
    for shape in sorted(shapes):
        spec = param_sharding(mesh, jax.ShapeDtypeStruct(shape, np.float32))
        axes = list(spec.spec) + [None] * (len(shape) - len(spec.spec))
        want = axes.index("model") if "model" in axes else None
        assert shard_dim(shape, n_model) == want, shape


def test_one_process_has_no_mesh_and_gathers_itself():
    from lighthand_tpu_torch.core.mesh import (
        create_mesh,
        data_group,
        data_index,
        is_host_leader,
        shard_model,
    )
    from lighthand_tpu_torch.eval.harness import _gather_rows

    cpu = torch.device("cpu")
    assert create_mesh(MeshSpec(1, 1), cpu) is None
    assert create_mesh(MeshSpec(), cpu) is None
    assert data_index(None) == (0, 1) and data_group(None) is None
    assert is_host_leader()
    model = torch.nn.Linear(2, 2)
    assert shard_model(model, None) is model
    tree = {"a": np.arange(3)}
    assert all_gather_metrics(tree) == [tree]
    assert _gather_rows(tree) is tree
    for spec in (MeshSpec(2, 1), MeshSpec(1, 2), MeshSpec(2, 2)):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            create_mesh(spec, cpu)


def test_dist_env_contract_without_variables(monkeypatch):
    from lighthand_tpu_torch.core import dist

    for k in ("LIGHTHAND_COORDINATOR", "LIGHTHAND_DIST"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.distributed_env_requested()
    assert not dist.maybe_initialize_distributed("cpu")
    assert dist.process_device("cpu") is None
    monkeypatch.setenv("LIGHTHAND_DIST", "1")
    assert dist.distributed_env_requested()
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert dist.local_rank() == 3


def test_failed_init_raises(monkeypatch):
    """A coordinator nobody listens at and a world of 2: the gloo
    rendezvous times out and raises; nothing goes on in one process."""
    import datetime

    import torch.distributed as dist

    from lighthand_tpu_torch.core import dist as port_dist

    monkeypatch.setenv("LIGHTHAND_COORDINATOR", f"localhost:{_free_port()}")
    monkeypatch.setenv("LIGHTHAND_NUM_PROCESSES", "2")
    monkeypatch.setenv("LIGHTHAND_PROCESS_ID", "1")
    real = dist.init_process_group
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: real(
        *a, timeout=datetime.timedelta(seconds=2), **k))
    with pytest.raises(Exception):
        port_dist.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()


if __name__ == "__main__":
    if sys.argv[1] == "trainer":
        _child_trainer(sys.argv[4])
    elif sys.argv[1] == "overlay":
        _child_overlay(sys.argv[4])
    else:
        _child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
