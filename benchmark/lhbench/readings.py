"""The readings that set a cell's limits of ``correct``: the numbers that
sound runs of the program give, and those of the control and of each
planted fault, seed by seed, all in one process. A benchmark run never
calls this.

The control is the nearest precision below the one the cell states:
where the cell states bf16, the program's own int8 path (its int8_fwd
policy); where it states int8, the reference with int4 backbone convs in
the program's place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from lhbench import faults, runner, spec

CONTROL_BITS = 4  # below int8


def reading(cell: spec.Cell, seed: int, mode: str, device: torch.device,
            seconds: float = 2.0, leaves: bool = False) -> dict:
    """The numbers compared in one run of ``cell`` under ``mode`` (sound,
    control, ``f32``, the program's own full-precision path as a witness,
    or one of ``faults.FAULTS``), with ``seconds`` of window for eval
    traffic (training reads its set-up only); with ``leaves``, a training
    cell's gaps leaf by leaf too (``leaf_gaps``)."""
    name = cell.mix["kind"]
    kind = spec.kind(name)
    int8_cell = cell.mix["precision"] == "int8_fwd"
    if mode == "control" and not int8_cell:
        cell = dataclasses.replace(cell, mix=dict(cell.mix,
                                                  precision="int8_fwd"))
    if mode == "f32":  # a witness: the program's own full-f32 path
        cell = dataclasses.replace(cell, mix=dict(cell.mix, precision="f32"))
    run = runner.Run(cell, seed, seconds, False, device, time.perf_counter())
    planted = (faults.plant(mode, name) if mode in faults.FAULTS
               else contextlib.nullcontext())
    with planted:
        kind.setup(run)
        if name == "eval_step":
            kind.window(run)
    kind.finish(run)
    gc.collect()
    if mode == "control" and int8_cell:
        checks = kind.judge(run, answers=kind.control_answers(
            run, CONTROL_BITS))
    else:
        checks = kind.judge(run)
    values = dict(checks.readings,
                  correct=checks.correct and run.failed == 0)
    if leaves and hasattr(run, "leaf_gaps"):
        values["leaf_gaps"] = run.leaf_gaps
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return values
