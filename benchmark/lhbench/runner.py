"""One run of one cell: set-up, the measured window, with ``--trace 1`` a
profiled sub-window, then the comparison with the reference; and the
result line.

``run_cell`` takes the device from its caller: the command line refuses
to run without a card (``run.py``), while the tests drive the same path
on the CPU at a tiny size.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from lhbench import spec, trace

GIB = 2 ** 30
# modules the process that prints a result may not hold once the window
# has closed, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "lighthand_tpu")


@dataclasses.dataclass
class Run:
    """A run's inputs and what it measured; the kinds and the metric
    readers keep their own fields on it too."""
    cell: spec.Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    started: float  # perf_counter at the start of the process
    setup_s: float = 0.0
    reference_s: float = 0.0  # the reference's seconds within set-up
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    summary: Optional[trace.Summary] = None
    memory_peak: int = 0
    kind_name: str = ""
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Note that the set-up's part ``name`` has ended."""
        self.marks.append((name, time.perf_counter()))


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {out.stderr.strip()}"


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, started: float) -> Run:
    """Set-up, window, optional profiled sub-window, then the judge."""
    kind = spec.kind(cell.mix["kind"])
    run = Run(cell, seed, seconds, traced, device, started,
              kind_name=cell.mix["kind"])
    run.mark("imports")
    kind.setup(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.mark("warm-up")
    run.setup_s = time.perf_counter() - started - run.reference_s
    kind.window(run)
    if traced:
        run.summary = kind.traced(run)
    if device.type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated(device)
    kind.finish(run)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = kind.judge(run)
    return run


def metrics(run: Run) -> Dict[str, dict]:
    """The cell's end-to-end metrics (untraced run) or its per-layer
    metrics (traced run), each ``{"value", "unit"}``; a reader that finds
    nothing is left out."""
    out = {}
    if not run.traced:
        values = dict(run.e2e, setup_s=run.setup_s,
                      peak_mem_gib=run.memory_peak / GIB)
        for m in run.cell.end_to_end:
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out
    for m in run.cell.per_layer:
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run: Run) -> dict:
    """The result line: ``checks`` comes last."""
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": run.memory_peak}
    line = {"correct": run.checks.correct and run.failed == 0,
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics(run), "device": device}
    if run.traced and run.summary is not None:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
        line["breakdown"] = trace.breakdown(run.summary)
    line["checks"] = run.checks.line()
    return line


def emit(run: Run, out=sys.stdout, err=sys.stderr) -> dict:
    """Print the ``#`` lines and the result line on ``out``, and the
    numbers compared, beside their limits, as the last lines of
    ``err``."""
    line = result(run)
    print(f"# {card_line() if run.device.type == 'cuda' else 'cpu'}",
          file=out)
    print(f"# setup {run.setup_s:.3f} s (and {run.reference_s:.3f} s of "
          f"the reference's, not counted), window {run.window_s:.3f} s, "
          f"{run.attempted} attempted, {run.failed} failed", file=out)
    last, parts = run.started, []
    for name, t in run.marks:
        parts.append(f"{name} {t - last:.3f}")
        last = t
    print(f"# setup s by part: {', '.join(parts)}", file=out)
    if run.summary is not None:
        for note in trace.notes(run.summary):
            print(f"# {note}", file=out)
    print(json.dumps(line), file=out, flush=True)
    for text in run.checks.lines():
        print(text, file=err)
    err.flush()
    return line
