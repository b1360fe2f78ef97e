"""Faults planted in the program under test, and the controls, for the
readings that set the limits of ``correct`` and for the tests that see a
broken timed path come out not correct. None is used by a benchmark run.

Each fault is a context manager that patches the port where the timed
path calls it, before the step is built:

- ``unchanged``: the optimizer step leaves the state as it was;
- ``half_batch``: the loss (training) or the sums (evaluation) take half
  the batch's rows, the mean over the rest;
- ``altered``: an answer altered where it is produced (the training loss
  reported twice as large; each eval batch's PCK count one too many).
"""

from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def plant(fault: str, kind: str):
    """Plant ``fault`` for traffic of ``kind`` for the span of the
    block."""
    from lighthand_tpu_torch.train import state as state_mod
    from lighthand_tpu_torch.train import step as step_mod

    if fault == "unchanged":
        def apply_gradients(self):
            self.step += 1
            return self
        with _patched(state_mod.TrainState, "apply_gradients",
                      apply_gradients):
            yield
        return
    if kind == "train_fused":
        mse = step_mod.joints_mse_loss
        if fault == "half_batch":
            def loss(pred, target):
                half = pred.shape[0] // 2
                return mse(pred[:half], target[:half])
        elif fault == "altered":
            def loss(pred, target):
                return mse(pred, target) * 2.0
        else:
            raise ValueError(f"unknown fault {fault}")
        with _patched(step_mod, "joints_mse_loss", loss):
            yield
        return
    if fault == "half_batch":
        to = step_mod._to

        def half_valid(x, device):
            x = to(x, device)
            if x is not None and x.ndim == 1 and x.is_floating_point():
                x = x.clone()
                x[x.shape[0] // 2:] = 0
            return x
        with _patched(step_mod, "_to", half_valid):
            yield
        return
    if fault == "altered":
        counts = step_mod.pck_2d_counts

        def one_more(*args, **kwargs):
            hits, total = counts(*args, **kwargs)
            return hits + 1, total
        with _patched(step_mod, "pck_2d_counts", one_more):
            yield
        return
    raise ValueError(f"unknown fault {fault}")
