"""The steps' CUDA-graph bookkeeping (``lighthand_tpu_torch/train/graph.py``)
on the CPU.

The CPU has no CUDA graphs, so ``DirectCalls`` takes the capture backend's
place: its capture runs the body once under ``no_host_sync`` and then puts
back what the run changed (the model's parameters and buffers, the
generator), as a capture that runs nothing on the device leaves them; its
replay runs the body on the static inputs, writes the results into the
capture's outputs and gradients, and gives the launch counters back their
values, as a replay runs no host code. Everything else is the card's
path: the per-key warm-up, capture and replay, the static inputs, the
cloned outputs, the counters' deltas, the gradients bound again before
Adam, one cache entry per state and shape.

hrnet_tiny at 64x64 (16x16 heatmaps), B=2. Every graphed run is held bit
for bit against the step's eager form (``step.eager``) from the same
weights, generator and batches; ``test_torch_step.py`` holds the eager
step against the JAX package.
"""

import contextlib
import functools
import socket

import numpy as np
import pytest
import torch

from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.layers import BatchNorm2d, quant_convs
from lighthand_tpu_torch.ops import quant
from lighthand_tpu_torch.ops.kernels import batch_norm as bn_kernels
from lighthand_tpu_torch.ops.kernels.fused_aug import fused_aug_targets_cuda
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda
from lighthand_tpu_torch.ops.kernels.int8_conv import (
    int8_conv2d_cuda,
    quantize_weights_cuda,
)
from lighthand_tpu_torch.train import graph, profiler
from lighthand_tpu_torch.train import step as port_step
from lighthand_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_fused_train_step,
    make_predict_step,
    make_train_step,
)

B, SIZE, HM, J = 2, 64, 16, 21

_REFUSED = ("item", "__float__", "__int__", "__bool__", "tolist", "cpu",
            "numpy")


class HostSync(AssertionError):
    pass


@contextlib.contextmanager
def no_host_sync():
    """Inside, ``Tensor.item`` / ``__float__`` / ``__int__`` / ``__bool__``
    / ``tolist`` / ``cpu`` / ``numpy``, and ``torch.tensor`` or
    ``torch.as_tensor`` of Python data, raise ``HostSync``: on the card
    each is a synchronisation or a pageable host-to-device copy, which a
    capture refuses (or bakes in)."""
    def refuse(name):
        def call(*args, **kwargs):
            raise HostSync(f"{name} in a captured body")
        return call

    saved = {name: torch.Tensor.__dict__.get(name) for name in _REFUSED}
    tensor, as_tensor = torch.tensor, torch.as_tensor

    def guarded_as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise HostSync("torch.as_tensor of host data in a captured body")
        return as_tensor(data, *args, **kwargs)

    try:
        for name in _REFUSED:
            setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        torch.tensor = refuse("torch.tensor")
        torch.as_tensor = guarded_as_tensor
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        torch.tensor, torch.as_tensor = tensor, as_tensor


class _Recorded:
    def __init__(self, outputs, grads):
        self.outputs = outputs
        self.grads = grads


class DirectCalls:
    """The capture backend with the body called directly (see the module's
    docstring); counts its warm-ups, captures and replays."""

    def __init__(self):
        self.calls = {"warmup": 0, "capture": 0, "replay": 0}

    def supports(self, device):
        return True

    def pool(self, device):
        return None

    def warmup(self, fn, device):
        self.calls["warmup"] += 1
        return fn()

    def capture(self, fn, *, device, pool, state, generator):
        self.calls["capture"] += 1
        held = {k: v.detach().clone()
                for k, v in state.model.state_dict(keep_vars=True).items()}
        drawn = None if generator is None else generator.get_state()
        with no_host_sync():
            out = fn()
        with torch.no_grad():
            for k, v in state.model.state_dict(keep_vars=True).items():
                v.copy_(held[k])
        if generator is not None:
            generator.set_state(drawn)
        grads = [(p, p.grad) for p in state.model.parameters()
                 if p.grad is not None]
        return _Recorded(graph._tuple(out), grads), out

    def replay(self, recorded, fn):
        self.calls["replay"] += 1
        before = graph.counts()
        out = graph._tuple(fn())
        graph.set_counts(before)
        for static, new in zip(recorded.outputs, out):
            static.copy_(new)
        for p, g in recorded.grads:
            g.copy_(p.grad)
            p.grad = g


@pytest.fixture
def direct(monkeypatch):
    backend = DirectCalls()
    monkeypatch.setattr(graph, "BACKEND", backend)
    return backend


@pytest.fixture
def counted(monkeypatch):
    """The kernel wrappers count their twins' calls in ``.launches``, as
    they count launches on the card; zeroed first. Each stand-in carries
    the wrapper's other attributes (the BatchNorm wrappers' ``.residuals``,
    which their own bodies count through the module's name)."""
    def counting(fn, launches=1):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            fn.launches += launches
            return fn(*args, **kwargs)
        return wrapper

    for module, name, fn, launches in (
            (port_step, "fused_aug_targets_cuda", fused_aug_targets_cuda, 1),
            (port_step, "generate_target_batch_cuda",
             generate_target_batch_cuda, 1),
            (quant, "quantize_weights_cuda", quantize_weights_cuda, 1),
            (quant, "int8_conv2d_cuda", int8_conv2d_cuda, 1),
            # a BatchNorm's training forward and its backward are three
            # launches each on the card, its eval forward one
            (bn_kernels, "batch_norm_train_cuda",
             bn_kernels.batch_norm_train_cuda, 3),
            (bn_kernels, "batch_norm_eval_cuda",
             bn_kernels.batch_norm_eval_cuda, 1),
            (bn_kernels, "batch_norm_backward_cuda",
             bn_kernels.batch_norm_backward_cuda, 3)):
        monkeypatch.setattr(module, name, counting(fn, launches))
    for fn in graph.COUNTED:
        monkeypatch.setattr(fn, "launches", 0)
    return graph.COUNTED


def _state(policy=None, seed=0):
    policy = policy or DTypePolicy.full_precision()
    return create_train_state(get_model("hrnet_tiny", policy=policy),
                              torch.Generator().manual_seed(seed), lr=1e-3,
                              device="cpu")


def _batch(seed, k=None, b=B, cols=2):
    """A fused step's batch [K?, B, ...]: u8 images, joints, the gates and
    hm_max."""
    rng = np.random.default_rng(seed)
    lead = (b,) if k is None else (k, b)
    return {
        "image_u8": torch.from_numpy(rng.integers(
            0, 256, size=lead + (SIZE, SIZE, 3), dtype=np.uint8)),
        "joints": torch.from_numpy(rng.uniform(
            6, SIZE - 6, size=lead + (J, cols)).astype(np.float32)),
        "aug_enabled": torch.from_numpy(
            (rng.uniform(size=lead) < 0.5).astype(np.float32)),
        "noise_enabled": torch.from_numpy(
            (rng.uniform(size=lead) < 0.5).astype(np.float32)),
        "hm_max": torch.from_numpy(
            (rng.uniform(size=lead) < 0.5).astype(np.float32)),
    }


def _assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def _assert_outputs_equal(got, want):
    if isinstance(got, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# (step kwargs, policy) of the fused step's cases
FUSED_CASES = {
    "k1": ({}, None),
    "per_sample": ({"target_style": "per_sample"}, None),
    "chain": ({"flip": True, "rot_deg": 15.0}, None),
    "int8_fwd": ({}, DTypePolicy.int8_fwd()),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_step_graphed_equals_eager(case, direct):
    """K=4 dispatches, then K=1 tail dispatches, then K=4 again, sharing a
    state and a generator as the Trainer's two steps do; the generator is
    reseeded before the last dispatch (a new epoch): every loss, the
    parameters, BN's stats, Adam's moments and the generator's state equal
    the eager steps' bit for bit. The K=4 step and the K=1 step each warm
    up once and capture once; every later microbatch replays."""
    kw, policy = FUSED_CASES[case]
    dtype = (policy or DTypePolicy.full_precision()).compute_dtype
    kw = dict(heatmap_size=HM, compute_dtype=dtype, device="cpu", **kw)
    runs = {}
    for mode in ("graphed", "eager"):
        state = _state(policy)
        gen = torch.Generator().manual_seed(5)
        step4 = make_fused_train_step(scan_steps=4, **kw)
        step1 = make_fused_train_step(scan_steps=1, **kw)
        if mode == "eager":
            step4, step1 = step4.eager, step1.eager
        losses = []
        plan = [(step4, 4)] * 2 + [(step1, None)] * 3 + [(step4, 4)]
        for i, (step, k) in enumerate(plan):
            if i == len(plan) - 1:
                gen.manual_seed(9)
            state, m = step(state, gen, _batch(10 + i, k))
            losses.append(m["loss"])
        runs[mode] = (state, gen, losses, step4, step1)
    (gs, gg, gl, g4, g1), (es, eg, el, _, _) = runs["graphed"], runs["eager"]
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    _assert_states_equal(gs, es)
    assert torch.equal(gg.get_state(), eg.get_state())
    assert len(g4.graphs) == 1 and len(g1.graphs) == 1
    assert g4.eager.graphs is None and g4.eager.eager is g4.eager
    # each step's first microbatch warms up, its second captures; every
    # microbatch from the second on replays
    assert direct.calls == {"warmup": 2, "capture": 2,
                            "replay": (3 * 4 - 1) + (3 - 1)}


def test_train_step_graphed_equals_eager(direct):
    """``make_train_step`` (normalised images, K2's targets): 3 calls."""
    runs = {}
    for mode in ("graphed", "eager"):
        state = _state()
        step = make_train_step(heatmap_size=HM, device="cpu")
        step = step if mode == "graphed" else step.eager
        losses = []
        for i in range(3):
            rng = np.random.default_rng(i)
            batch = {"image": torch.from_numpy(rng.normal(
                size=(B, SIZE, SIZE, 3)).astype(np.float32)),
                "joints": _batch(i)["joints"]}
            state, m = step(state, batch)
            losses.append(m["loss"])
        runs[mode] = (state, losses)
    assert all(torch.equal(a, b)
               for a, b in zip(runs["graphed"][1], runs["eager"][1]))
    _assert_states_equal(runs["graphed"][0], runs["eager"][0])
    assert direct.calls == {"warmup": 1, "capture": 1, "replay": 2}


@pytest.mark.parametrize("cols,padded", [(2, True), (3, False)])
def test_eval_and_predict_graphed_equal_eager(cols, padded, direct):
    """The eval step (a padded batch's ``valid`` mask, visibility joints)
    and the predict step over 3 batches each: every output equals the
    eager step's bit for bit, and a kept output is not overwritten by the
    next call."""
    state = _state()
    _train(state)
    eval_step = make_eval_step(heatmap_size=HM, stride=4.0, device="cpu")
    predict = make_predict_step(stride=4.0, device="cpu")
    kept = []
    for i in range(3):
        rng = np.random.default_rng(20 + i)
        images = torch.from_numpy(rng.normal(
            size=(B + 2, SIZE, SIZE, 3)).astype(np.float32))
        joints = _batch(i, b=B + 2, cols=cols)["joints"]
        if cols == 3:
            joints[..., 2] = torch.from_numpy(
                (rng.uniform(size=(B + 2, J)) < 0.8).astype(np.float32))
        batch = {"image": images, "joints": joints}
        if padded:
            batch["valid"] = torch.tensor([1.0] * B + [0.0] * 2)
        got = eval_step(state, batch)
        _assert_outputs_equal(got, eval_step.eager(state, batch))
        if padded:
            assert float(got["n_valid"]) == B
        got_p = predict(state, images)
        _assert_outputs_equal(got_p, predict.eager(state, images))
        kept.append((got, got_p, eval_step.eager(state, batch),
                     predict.eager(state, images)))
    for got, got_p, want, want_p in kept:
        _assert_outputs_equal(got, want)
        _assert_outputs_equal(got_p, want_p)
    assert len(eval_step.graphs) == 1 and len(predict.graphs) == 1
    assert direct.calls == {"warmup": 2, "capture": 2, "replay": 4}


def _train(state, steps=2):
    step = make_fused_train_step(heatmap_size=HM,
                                 compute_dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(steps):
        step.eager(state, gen, _batch(40 + i))


def test_replays_add_the_counters_captured_deltas(direct, counted):
    """The counters count each launch of a replayed microbatch as the
    eager step does: K1 one a microbatch; under int8_fwd the grouped
    weight quantize one a forward and the int8 conv one a quantized conv;
    K2 one an eval call; each BatchNorm three in a training forward and
    one in an eval forward (its backward, three on the card, is autograd's
    through the twin on the CPU and calls no wrapper there). A
    capture itself counts nothing."""
    policy = DTypePolicy.int8_fwd()
    model = get_model("hrnet_tiny", policy=policy)
    n_quant = len(quant_convs(model))
    n_bn = sum(isinstance(m, BatchNorm2d) for m in model.modules())
    seen = {}
    for mode in ("graphed", "eager"):
        graph.set_counts([0] * len(graph.COUNTED))
        state = _state(policy)
        step = make_fused_train_step(scan_steps=2, heatmap_size=HM,
                                     device="cpu")
        eval_step = make_eval_step(heatmap_size=HM, device="cpu")
        if mode == "eager":
            step, eval_step = step.eager, eval_step.eager
        gen = torch.Generator().manual_seed(1)
        per_call = []
        for i in range(3):
            before = graph.counts()
            step(state, gen, _batch(i, k=2))
            eval_step(state, {"image": torch.zeros(B, SIZE, SIZE, 3),
                              "joints": _batch(i)["joints"]})
            per_call.append([a - b for a, b in zip(graph.counts(), before)])
        seen[mode] = per_call
    # K1, K2, quantize, conv, BatchNorm forward, eval and backward
    want = [2, 1, 2 + 1, n_quant * 3, 2 * 3 * n_bn, n_bn, 0]
    assert n_quant > 0 and n_bn > 0
    assert seen["eager"] == [want] * 3
    assert seen["graphed"] == seen["eager"]


def test_a_new_shape_or_state_captures_anew(direct):
    """One entry per (state, generator, input shapes): a new batch size
    warms up and captures anew, as does a new state; a state that is gone
    takes its graphs with it."""
    step = make_fused_train_step(heatmap_size=HM,
                                 compute_dtype=torch.float32, device="cpu")
    state, gen = _state(), torch.Generator().manual_seed(0)
    for b in (B, B, B, B + 1, B + 1, B):
        step(state, gen, _batch(b, b=b))
    assert direct.calls == {"warmup": 2, "capture": 2, "replay": 4}
    assert len(step.graphs) == 2
    other = _state(seed=1)
    step(other, gen, _batch(0))
    step(other, gen, _batch(1))
    assert len(step.graphs) == 3
    del state, other
    step(_state(seed=2), gen, _batch(2))  # a new key drops the dead ones
    assert len(step.graphs) == 0
    assert direct.calls["capture"] == 3


def test_a_host_sync_in_a_body_fails_the_capture(direct, monkeypatch):
    """The guard sees a host read in a captured body, and the capture
    raises with the step's name: no eager fallback; the next call of the
    key captures again and raises again."""
    def reading(pred, target):
        return 0.5 * torch.mean((pred.float() - target.float()) ** 2) + (
            0.0 * float(target.sum()))

    monkeypatch.setattr(port_step, "joints_mse_loss", reading)
    step = make_fused_train_step(heatmap_size=HM,
                                 compute_dtype=torch.float32, device="cpu")
    state, gen = _state(), torch.Generator().manual_seed(0)
    step(state, gen, _batch(0))  # the warm-up runs eagerly
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture of "
                           r"make_fused_train_step\(scan_steps=1\) failed"):
            step(state, gen, _batch(1))
    assert direct.calls == {"warmup": 1, "capture": 2, "replay": 0}


def test_guard_refuses_each_host_read():
    x = torch.ones(3)
    for read in (lambda: x.sum().item(), lambda: float(x[0]),
                 lambda: int(x[0]), lambda: bool(x[0]), lambda: x.tolist(),
                 lambda: x.cpu(), lambda: x.numpy(),
                 lambda: torch.tensor([1.0]),
                 lambda: torch.as_tensor([1.0])):
        with no_host_sync(), pytest.raises(HostSync):
            read()
    assert x.sum().item() == 3.0 and torch.as_tensor(x) is x


def _train_calls(direct, n):
    """``n`` calls of a fused train step on one state and shape (a
    warm-up, a capture, then replays); returns the step."""
    step = make_fused_train_step(heatmap_size=HM,
                                 compute_dtype=torch.float32, device="cpu")
    state, gen = _state(), torch.Generator().manual_seed(0)
    for i in range(n):
        step(state, gen, _batch(i))
    return step


def test_no_profiler_no_spans_and_the_counters_count(direct):
    """With no profiler open nothing is recorded, and the process's
    counters count the capture, its host seconds and every replay."""
    profiler.spans(clear=True)
    before = graph.totals()
    _train_calls(direct, 4)
    after = graph.totals()
    assert direct.calls == {"warmup": 1, "capture": 1, "replay": 3}
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 3
    assert after["capture_s"] > before["capture_s"]
    assert profiler.spans() == profiler.SpanLog((), 0)


def test_spans_of_each_call_under_a_cpu_profiler(direct):
    """Under a CPU profiler each call is a ``graph.call`` span labelled
    with the step's name around its children: the warm-up; the capture,
    replay, rebind and clone; then copy-in, replay, rebind and clone. The
    record's times lie within 1 ms of the mirrored ranges'."""
    from torch.profiler import ProfilerActivity, profile

    profiler.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step = _train_calls(direct, 3)
    log = profiler.spans()
    assert log.dropped == 0
    calls = [i for i, s in enumerate(log.spans)
             if s.name == "lighthand.graph.call"]
    assert len(calls) == 3
    children = [[s.name.removeprefix("lighthand.graph.")
                 for s in log.spans if s.parent == i] for i in calls]
    assert children == [["warmup"],
                        ["capture", "replay", "rebind", "clone"],
                        ["copy_in", "replay", "rebind", "clone"]]
    for i in calls:
        span = log.spans[i]
        assert span.parent == -1 and span.label == step.graphs.name
        assert span.start_ns <= span.end_ns
    for s in log.spans:
        assert s.name.startswith("lighthand.graph.")
        assert not s.name.startswith("lhbench.")
        assert s.parent < log.spans.index(s)
    mirrored = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in prof.profiler.kineto_results.events()
                      if e.name() == "lighthand.graph.call")
    assert len(mirrored) == 3
    for i, (lo, hi) in zip(calls, mirrored):
        assert abs(log.spans[i].start_ns - lo) < 1_000_000
        assert abs(log.spans[i].end_ns - hi) < 1_000_000


def test_the_span_record_is_bounded():
    """The record keeps ``SPAN_LIMIT`` (65,536) spans; the next is counted
    in ``dropped`` and not stored."""
    from torch.profiler import ProfilerActivity, profile

    profiler.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(profiler.SPAN_LIMIT + 1):
            with profiler.annotate("bounded"):
                pass
    log = profiler.spans(clear=True)
    assert profiler.SPAN_LIMIT == 65_536
    assert len(log.spans) == profiler.SPAN_LIMIT and log.dropped == 1
    assert {s.name for s in log.spans} == {"lighthand.bounded"}
    assert profiler.spans() == profiler.SpanLog((), 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_mesh_keeps_every_step_eager(direct, caplog):
    """Under a (one-process, gloo) mesh every step is its eager form and
    logs that once when it is built; the backend is never called."""
    import torch.distributed as dist

    from lighthand_tpu_torch.core.mesh import MeshSpec, create_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = create_mesh(MeshSpec(1, 1), torch.device("cpu"))
        with caplog.at_level("WARNING", logger="lighthand_tpu_torch"):
            steps = [make_fused_train_step(heatmap_size=HM, device="cpu",
                                           compute_dtype=torch.float32,
                                           mesh=mesh),
                     make_eval_step(heatmap_size=HM, device="cpu", mesh=mesh),
                     make_predict_step(device="cpu", mesh=mesh)]
        state, gen = _state(), torch.Generator().manual_seed(0)
        for _ in range(3):
            steps[0](state, gen, _batch(0))
            steps[1](state, {"image": torch.zeros(B, SIZE, SIZE, 3),
                             "joints": _batch(0)["joints"]})
            steps[2](state, torch.zeros(B, SIZE, SIZE, 3))
    finally:
        dist.destroy_process_group()
    assert all(s.graphs is None and s.eager is s for s in steps)
    assert direct.calls == {"warmup": 0, "capture": 0, "replay": 0}
    logged = [r.getMessage() for r in caplog.records
              if "runs eagerly" in r.getMessage()]
    assert len(logged) == 3


def test_the_cpu_runs_the_eager_form():
    """With the card's backend, a CPU step is its eager form."""
    assert not graph.BACKEND.supports(torch.device("cpu"))
    for step in (make_fused_train_step(device="cpu"),
                 make_train_step(device="cpu"), make_eval_step(device="cpu"),
                 make_predict_step(device="cpu")):
        assert step.graphs is None and step.eager is step


def _trainer_cfg(tmp_path, tag):
    """resnet18 at 32x32 (8x8 heatmaps), batch 8, 40 synthetic samples, 3
    microbatches a dispatch (one K=3 dispatch and a K=1 tail of 2 an
    epoch), overlays on, 2 epochs."""
    from lighthand_tpu_torch.config import Config

    cfg = Config(name=f"resnet18/ours/{tag}", root_path=str(tmp_path))
    cfg.platform = "cpu"
    cfg.model.name = "resnet18"
    cfg.model.precision = "f32"
    cfg.data.dataset = "ours"
    cfg.data.synthetic = True
    cfg.data.image_size = 32
    cfg.data.heatmap_size = 8
    cfg.data.batch_size = 8
    cfg.data.num_our = 40
    cfg.data.num_workers = 2
    cfg.train.steps_per_dispatch = 3
    cfg.train.epochs = 2
    cfg.train.lr = 1e-3
    cfg.train.early_stop_count = 50
    cfg.train.visualize = True
    cfg.output_dir = str(tmp_path / cfg.name)
    cfg.tensorboard_dir = str(tmp_path / "tb" / tag)
    return cfg


def test_trainer_graphed_equals_eager(tmp_path, monkeypatch):
    """The Trainer through its graphed steps (the K=3 dispatch, the K=1
    tail, the padded eval batch, the overlays' predict) against the same
    run on the eager steps: the per-epoch losses and the overlays' files
    are equal, and so are the trained weights."""
    import json
    import os
    import re

    from lighthand_tpu_torch.train import loop

    runs = {}
    for tag in ("eager", "graphed"):
        if tag == "graphed":
            backend = DirectCalls()
            monkeypatch.setattr(graph, "BACKEND", backend)
        cfg = _trainer_cfg(tmp_path, tag)
        trainer = loop.Trainer(cfg)
        trainer.fit()
        with open(os.path.join(cfg.output_dir, "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [(r["tag"], r["step"], r["value"]) for r in rows
                  if r["tag"].startswith("Loss/")]
        images = {}
        for d, _, files in os.walk(cfg.output_dir):
            for name in files:
                if name.endswith(".jpg"):
                    with open(os.path.join(d, name), "rb") as f:
                        images[os.path.relpath(os.path.join(d, name),
                                               cfg.output_dir)] = f.read()
        with open(os.path.join(cfg.output_dir, "log.txt")) as f:
            captured = [tuple(int(n) for n in m) for m in re.findall(
                r"CUDA graph captures (\d+) \(.*\) and replays (\d+)",
                f.read())]
        runs[tag] = (losses, images, trainer.state, captured)
    assert runs["graphed"][0] == runs["eager"][0] and len(runs["eager"][0]) == 4
    # each epoch's log line counts its captures (in the first the K=3 and
    # K=1 train steps and the overlays' predict) and its replays: each
    # epoch makes 8 step calls, of which the first epoch's 3 warm-ups run
    # eagerly
    assert runs["eager"][3] == [(0, 0), (0, 0)]
    assert runs["graphed"][3] == [(3, 5), (0, 8)]
    assert runs["graphed"][1] == runs["eager"][1] and runs["eager"][1]
    _assert_states_equal(runs["graphed"][2], runs["eager"][2])
    # train K=3, train K=1, eval and predict each captured once
    assert backend.calls["capture"] == 4
