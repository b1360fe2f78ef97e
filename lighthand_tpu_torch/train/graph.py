"""The steps as captured CUDA graphs: the port's counterpart of ``jax.jit``.

Every step of the JAX package is a compiled program, one host call a
dispatch (``lighthand_tpu/train/step.py``: ``jax.jit``, with ``lax.scan``
over K microbatches in the fused step). Run eagerly, a port step is
thousands of kernel launches from Python (an HRNet-W32 forward alone is
about 2,000). On the card each step of ``train/step.py`` runs its body,
the device work with no host decision in it, through ``StepGraphs``: a
cache of CUDA graphs keyed as ``jax.jit`` keys its programs, by the body's
input shapes, dtypes and strides, and here also by the ``TrainState``, the
generator and the numerics switches (TF32, cuDNN's algorithm choice).

- The first call of a key runs the body eagerly on the capture stream
  (PyTorch's capture recipe warms up on a side stream). It is a real step.
- The second call copies its inputs into static buffers, captures the body
  into a graph (the device runs nothing meanwhile), then replays it.
- Later calls copy their inputs into the static buffers and replay.

Capture leaves no trace. The device runs nothing while the host records,
so the model, BatchNorm's running stats and ``num_batches_tracked`` stay
as they were. The generator is registered with the graph: its offset moves
only when a replay draws, by what the body draws, and a ``manual_seed``
between replays holds. The kernel wrappers' launch counters (``COUNTED``),
which count on the host, get back their values from before the capture,
and every replay adds what the capture counted.

Outputs are cloned out of the static buffers, as JAX returns new arrays.
A training body leaves its gradients in the graph's static ``.grad``
tensors (``zero_grad(set_to_none=True)`` in the body: the backward at
capture allocates them). After each replay the parameters' ``.grad`` are
bound to them again, since another step's graph or an eager step may have
rebound them, and then the caller runs Adam eagerly.

All graphs on a device share one memory pool, as
``torch.cuda.make_graphed_callables`` shares one among its graphs: replays
run one after another on the caller's stream, and each graph's static
tensors stay referenced while the graph lives, so no graph's memory is
handed to another while it is in use. Under a
``torch.distributed`` mesh the steps stay eager: their all-reduces are
NCCL calls, which are not captured. On the CPU they are eager as well
(``CudaGraphs.supports``). A capture that fails raises with the step's
name and its inputs; nothing falls back to the eager step.

Each call is the span ``graph.call`` (``train/profiler.py:annotate``),
labelled with the step's name, around ``graph.warmup`` (a key's first
call) or ``graph.capture``, ``graph.copy_in``, ``graph.replay`` (the
graph's launch), ``graph.rebind`` (the ``.grad`` loop) and
``graph.clone``: recorded only while a profiler window is open. The
counters of ``totals()`` always count, over every ``StepGraphs`` of the
process: ``captures``, ``capture_s`` (host seconds in ``_capture``) and
``replays``.

``BACKEND`` captures and replays. A test replaces it with one that calls
the body directly; that is how the CPU tests exercise this bookkeeping.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Sequence

import torch

from lighthand_tpu_torch.ops.kernels.batch_norm import (
    batch_norm_backward_cuda,
    batch_norm_eval_cuda,
    batch_norm_train_cuda,
)
from lighthand_tpu_torch.ops.kernels.fused_aug import fused_aug_targets_cuda
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda
from lighthand_tpu_torch.ops.kernels.int8_conv import (
    int8_conv2d_cuda,
    quantize_weights_cuda,
)
from lighthand_tpu_torch.train.profiler import annotate

# the kernel wrappers of the steps; each counts its launches in .launches
COUNTED = (fused_aug_targets_cuda, generate_target_batch_cuda,
           quantize_weights_cuda, int8_conv2d_cuda, batch_norm_train_cuda,
           batch_norm_eval_cuda, batch_norm_backward_cuda)


def counts() -> list:
    return [f.launches for f in COUNTED]


def set_counts(values: Sequence[int]) -> None:
    for f, v in zip(COUNTED, values):
        f.launches = v


# what every StepGraphs of the process has done: kept here, not on the
# instances, so that they outlive the steps that a caller frees
_TOTALS = {"captures": 0, "capture_s": 0.0, "replays": 0}


def totals() -> dict:
    """The captures made, their host seconds and the replays run so far
    in this process."""
    return dict(_TOTALS)


class CudaGraphs:
    """The capture backend on the card: ``torch.cuda.CUDAGraph`` captured
    on one side stream per device, which the warm-up uses too."""

    def __init__(self):
        self._streams = {}
        self._graphs = {}  # device index -> the graphs captured there

    def supports(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        index = (torch.cuda.current_device() if device.index is None
                 else device.index)
        if index not in self._streams:
            self._streams[index] = torch.cuda.Stream(index)
        return self._streams[index]

    def _live(self, device: torch.device) -> weakref.WeakSet:
        index = self.stream(device).device.index
        return self._graphs.setdefault(index, weakref.WeakSet())

    def pool(self, device: torch.device):
        """The memory pool for a new graph on ``device``: that of the
        graphs living there, or a new one where none lives (a pool whose
        graphs are all gone may not take a new capture)."""
        for graph in self._live(device):
            return graph.pool()
        return torch.cuda.graph_pool_handle()

    def warmup(self, fn: Callable, device: torch.device):
        side = self.stream(device)
        current = torch.cuda.current_stream(side.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn()
        current.wait_stream(side)
        return out

    def capture(self, fn: Callable, *, device: torch.device, pool, state,
                generator):
        """(the graph of ``fn``, what ``fn`` returned at capture), with
        ``generator`` registered: its draws in the graph follow its state at
        each replay."""
        del state  # the graph holds no Python object
        graph = torch.cuda.CUDAGraph()
        side = self.stream(device)
        if (generator is not None and generator
                is not torch.cuda.default_generators[side.device.index]):
            graph.register_generator_state(generator)
        with torch.cuda.graph(graph, pool=pool, stream=side):
            out = fn()
        self._live(device).add(graph)
        return graph, out

    def replay(self, graph, fn: Callable) -> None:
        del fn  # the graph replays what the capture recorded
        graph.replay()


BACKEND = CudaGraphs()


def _signature(inputs) -> tuple:
    return tuple(None if x is None else
                 (tuple(x.shape), x.dtype, x.stride(), x.device)
                 for x in inputs)


def _switches() -> tuple:
    """The switches that decide which kernels a body launches."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _Entry:
    """One key's warm-up, then its graph, static inputs and outputs."""

    def __init__(self, state, generator):
        # the state weakly (its graphs go with it); the generator strongly,
        # as torch's generators take no weak reference
        self.state = weakref.ref(state)
        self.generator = generator
        self.graph = None
        self.static = None
        self.outputs = ()
        self.deltas = [0] * len(COUNTED)
        self.grads = []

    def holds(self, state, generator) -> bool:
        return self.state() is state and self.generator is generator

    def alive(self) -> bool:
        return self.state() is not None


class StepGraphs:
    """The CUDA graphs of one step's ``body(state, generator, *inputs)``,
    which returns a tensor or a tuple of tensors and does no host work that
    a replay would have to repeat. ``trains``: the body runs a backward,
    whose static ``.grad`` tensors are bound to the parameters after each
    replay."""

    def __init__(self, name: str, body: Callable, trains: bool = False):
        self.name = name
        self.body = body
        self.trains = trains
        self.backend = BACKEND
        self._entries = {}

    def __len__(self) -> int:
        """The graphs captured so far."""
        return sum(e.graph is not None for e in self._entries.values())

    def __call__(self, state, generator, inputs: Sequence) -> tuple:
        """The body's outputs on ``inputs`` (tensors or None), as a tuple:
        the warm-up's own at a key's first call, clones of the static
        outputs after a replay."""
        with annotate("graph.call", self.name):
            return self._call(state, generator, inputs)

    def _call(self, state, generator, inputs: Sequence) -> tuple:
        key = (id(state), id(generator), _signature(inputs), _switches())
        entry = self._entries.get(key)
        if entry is not None and not entry.holds(state, generator):
            entry = None  # an id reused by a new object
        if entry is None:
            self._entries = {k: e for k, e in self._entries.items()
                             if e.alive()}
            self._entries[key] = _Entry(state, generator)
            with annotate("graph.warmup"):
                return _tuple(self.backend.warmup(
                    lambda: self.body(state, generator, *inputs),
                    state.device))
        if entry.graph is None:
            with annotate("graph.capture"):
                self._capture(entry, state, generator, inputs)
        else:
            with annotate("graph.copy_in"):
                for s, x in zip(entry.static, inputs):
                    if s is not None:
                        s.copy_(x)
        with annotate("graph.replay"):
            self.backend.replay(entry.graph, lambda: self.body(
                state, generator, *entry.static))
        _TOTALS["replays"] += 1
        for f, d in zip(COUNTED, entry.deltas):
            f.launches += d
        with annotate("graph.rebind"):
            for p, g in entry.grads:
                if p.grad is not g:
                    p.grad = g
        with annotate("graph.clone"):
            return tuple(o.clone() for o in entry.outputs)

    def _capture(self, entry: _Entry, state, generator, inputs) -> None:
        t0 = time.perf_counter()
        entry.static = [None if x is None else x.clone() for x in inputs]
        before = counts()
        try:
            entry.graph, out = self.backend.capture(
                lambda: self.body(state, generator, *entry.static),
                device=state.device, pool=self.backend.pool(state.device),
                state=state, generator=generator)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed for inputs "
                f"{_signature(inputs)}: {exc}") from exc
        finally:
            after = counts()
            set_counts(before)
        entry.deltas = [a - b for a, b in zip(after, before)]
        entry.outputs = _tuple(out)
        if self.trains:
            entry.grads = [(p, p.grad) for p in state.model.parameters()
                           if p.grad is not None]
        _TOTALS["captures"] += 1
        _TOTALS["capture_s"] += time.perf_counter() - t0
