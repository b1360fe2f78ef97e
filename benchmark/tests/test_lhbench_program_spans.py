"""The readers of the program's own spans and counters (``step_host_ms``,
``replay_host_ms``, ``capture_s.setup``), on a tiny traced run on the CPU.

The CPU's steps are eager, so ``Direct`` takes the capture backend's
place, as in the program's own tests: a capture runs the body once and
keeps what it returned and the gradients it left, a replay runs it again
and writes its results there. The state moves at a capture, which on the
card it does not; these tests read only the spans and the counters."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import tiny_cell
from lhbench import runner, spec, trace

READERS = ("step_host_ms.train", "step_host_ms.eval", "replay_host_ms.train",
           "replay_host_ms.eval", "capture_s.setup")


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class Direct:
    """The capture backend with the body called directly."""

    def supports(self, device):
        return True

    def pool(self, device):
        return None

    def warmup(self, fn, device):
        return fn()

    def capture(self, fn, *, device, pool, state, generator):
        out = fn()
        grads = [(p, p.grad) for p in state.model.parameters()
                 if p.grad is not None]
        return (_tuple(out), grads), out

    def replay(self, recorded, fn):
        outputs, grads = recorded
        for static, new in zip(outputs, _tuple(fn())):
            static.copy_(new)
        for p, g in grads:
            g.copy_(p.grad)


def _read(run) -> dict:
    return {m["name"]: spec.reader(m["name"]).read(run)
            for m in run.cell.per_layer if m["name"] in READERS}


@pytest.mark.parametrize("name", ["w32.train.b128", "r50.eval.b32.int8"])
def test_readers_of_a_traced_run_with_graphed_steps(name, monkeypatch):
    """Each reader that the cell lists reads a positive number; the graph
    launch is part of the step call."""
    from lighthand_tpu_torch.train import graph, profiler

    monkeypatch.setattr(graph, "BACKEND", Direct())
    profiler.spans(clear=True)
    run = runner.run_cell(tiny_cell(name), 2**31 + 11, 0.3, True,
                          torch.device("cpu"), time.perf_counter())
    got = _read(run)
    kind = "train" if "train" in name else "eval"
    assert set(got) == {f"step_host_ms.{kind}", f"replay_host_ms.{kind}",
                        "capture_s.setup"}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got[f"replay_host_ms.{kind}"] <= got[f"step_host_ms.{kind}"]
    names = {s.name for s in profiler.spans().spans}
    assert "lighthand.graph.call" in names
    assert not any(n.startswith(trace.SPAN_PREFIX) for n in names)
    line = runner.result(run)
    assert set(got) <= set(line["metrics"])


def test_readers_without_spans_or_captures(monkeypatch):
    """No span recorded and nothing captured (the CPU's eager steps), or
    no profiled window at all: every reader reads None."""
    from lighthand_tpu_torch.train import graph, profiler

    monkeypatch.setattr(graph, "_TOTALS",
                        {"captures": 0, "capture_s": 0.0, "replays": 0})
    profiler.spans(clear=True)

    class Run:
        summary = trace.read([], 0.0, 2)

    class Untraced:
        summary = None

    for name in READERS:
        assert spec.reader(name).read(Run) is None, name
        assert spec.reader(name).read(Untraced) is None, name
