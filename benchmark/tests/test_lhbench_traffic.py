"""Each kind of traffic runs through the harness's own functions at a tiny
size on the CPU (the command line itself refuses to run without a card):
set-up, the window, the judge and the result line."""

from __future__ import annotations

import io
import json
import time

import pytest
import torch

from conftest import tiny_cell
from lhbench import runner, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
CPU = torch.device("cpu")


def _run(cell, traced=False, seconds=0.5, seed=2**31 + 77):
    return runner.run_cell(cell, seed, seconds, traced, CPU,
                           time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_full_precision_program_equals_the_reference(name):
    """Under the f32 policy the program computes what the reference does:
    every number compared lies far inside the cell's limits (the
    parameters' change after a few Adam steps of a tiny model moves most:
    Adam scales the round-off of gradients near zero to a step)."""
    run = _run(tiny_cell(name, precision="f32"))
    assert run.checks.correct and run.failed == 0
    assert run.attempted > 0
    for value in run.checks.values.values():
        assert value < 2e-2


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    cell = tiny_cell(name)
    run = _run(cell, traced=True)
    out, err = io.StringIO(), io.StringIO()
    line = runner.emit(run, out, err)
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(line))
    assert list(printed)[:5] == ["correct", "attempted", "failed",
                                 "metrics", "device"]
    assert list(printed)[-1] == "checks"
    assert set(printed["checks"]) == set(cell.limits)
    assert err.getvalue().strip().splitlines()[-1].startswith("check ")
    # a traced run reports per-layer metrics; on the CPU the trace holds
    # no device operation, so only the host's readers find anything
    assert set(printed["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert all(m["source"] in ("host_clock", "program_span")
               for m in cell.per_layer if m["name"] in printed["metrics"])
    untraced = runner.result(_run(cell))
    assert set(untraced["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_same_seed_same_inputs():
    from lhbench import inputs

    a = inputs.pool(2, 64, 0.6, inputs.seeds(2**31 + 5), CPU, count=2)
    b = inputs.pool(2, 64, 0.6, inputs.seeds(2**31 + 5), CPU, count=2)
    c = inputs.pool(2, 64, 0.6, inputs.seeds(2**31 + 6), CPU, count=2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image_u8"], c["image_u8"])
