"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program, through the rest of a
run (the look for a card skipped, tiny sizes, the cells' own limits), and
the control of the int8 cell at a tiny size. The controls of the bf16
cells at their own sizes are card tests."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_cell
from lhbench import faults, readings, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the faults each kind of cell can have (one chip: no exchange to leave out)
CAN_HAVE = {"train_fused": ("unchanged", "half_batch", "altered"),
            "eval_step": ("half_batch", "altered")}
CASES = [(c, f) for c in CELLS
         for f in CAN_HAVE[spec.cell(BENCH, c).mix["kind"]]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_comes_out_not_correct(name, fault):
    cell = tiny_cell(name, precision="f32")
    assert readings.reading(cell, 2**31 + 3, "sound", CPU, 0.3)["correct"]
    assert not readings.reading(cell, 2**31 + 3, fault, CPU, 0.3)["correct"]


def test_faults_are_known():
    assert {f for fs in CAN_HAVE.values() for f in fs} <= set(faults.FAULTS)


def test_int4_control_comes_out_not_correct():
    cell = tiny_cell("r50.eval.b32.int8")
    assert not readings.reading(cell, 2**31 + 9, "control", CPU,
                                0.3)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct_at_the_cells_size(name, card):
    """The nearest lower precision in the program's place, at the cell's
    own size, on three seeds."""
    cell = spec.cell(BENCH, name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        assert not readings.reading(cell, seed, "control", card,
                                    2.0)["correct"]


@pytest.mark.parametrize("name", [c for c in CELLS if spec.cell(
    BENCH, c).mix["kind"] == "train_fused"])
def test_one_leaf_left_unmoved_comes_out_not_correct(name, monkeypatch):
    """A fault confined to one leaf (the stem's BatchNorm scale gets no
    gradient, so Adam never moves it): the medians over the leaves stay
    inside their limits, the worst leaf fails."""
    from lighthand_tpu_torch.train import state as state_mod

    apply = state_mod.TrainState.apply_gradients

    def apply_gradients(self):
        dict(self.model.named_parameters())["bn1.weight"].grad.zero_()
        return apply(self)

    monkeypatch.setattr(state_mod.TrainState, "apply_gradients",
                        apply_gradients)
    cell = tiny_cell(name, precision="f32")
    got = readings.reading(cell, 2**31 + 3, "sound", CPU, 0.3)
    assert not got["correct"]
    assert got["change_setup"] > cell.limits["change_setup"]
    for number in ("change3_median", "change_setup_median"):
        assert got[number] <= cell.limits[number]
