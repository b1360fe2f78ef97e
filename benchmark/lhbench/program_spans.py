"""What the readers of the program's own spans and counters share: the
spans that ``lighthand_tpu_torch/train/profiler.py:spans`` recorded while
a profiler was open (in a benchmark process, the traced sub-window
alone), and the process's CUDA-graph counters,
``lighthand_tpu_torch/train/graph.py:totals``.

A program that lacks them (an earlier commit) reads None, as does a run
whose trace recorded none of the spans asked for (the CPU's steps are
eager)."""

from __future__ import annotations

import importlib


def _program(module: str, name: str):
    """``lighthand_tpu_torch.<module>.<name>``, or None where the program
    has no such name."""
    return getattr(importlib.import_module(f"lighthand_tpu_torch.{module}"),
                   name, None)


def host_ms_per_unit(run, name: str):
    """Host ms a microbatch (or batch) inside the program's spans named
    ``name`` (``lighthand.<...>``), read without clearing the record."""
    s = run.summary
    spans = _program("train.profiler", "spans")
    if s is None or not s.units or spans is None:
        return None
    hits = [sp.end_ns - sp.start_ns for sp in spans().spans
            if sp.name == name and sp.end_ns is not None]
    return None if not hits else sum(hits) / 1e6 / s.units


def capture_s(run):
    """Host seconds of every CUDA-graph capture of the process (in a sound
    run, set-up's alone), or None where nothing was captured."""
    totals = _program("train.graph", "totals")
    if run.summary is None or totals is None:
        return None
    now = totals()
    return now["capture_s"] if now["captures"] else None
