"""Traffic of the kind ``train_fused``: the training CLI's epoch loop
(``train/loop.py:run_train_epoch``) over device batches, a closed loop.

Each dispatch stacks the next ``scan_steps`` microbatches of the pool with
``torch.stack`` (as the loop stacks the Loader's device batches) and calls
``make_fused_train_step(..., jitter=True, target_style="msra")``, which
runs K1, the forward, the backward and Adam for each; each dispatch's
loss is read with ``float()`` one dispatch late. The pool is
``inputs.POOL`` seeded microbatches, made at set-up and left on the
device, as the Loader would have put them there.

Set-up builds one train state and drives it through two dispatches (the
first captures the step's graph at its second microbatch) before the
window; the reference follows those eight optimizer steps.

A mix's parameters: ``batch``, ``scan_steps``, ``precision``, ``lr``,
``aug_share`` (the share of samples with ColorJitter on),
``trace_dispatches`` (the profiled sub-window of a traced run).
"""

from __future__ import annotations

import math
import time

import torch

from lhbench import inputs, program, trace
from lhbench.judge import (Checks, kept_leaves, leaf_gaps, median_leaf,
                           relative, worst_leaf)
from reference import models as ref_models
from reference import steps as ref_steps

SETUP_DISPATCHES = 2
FIELDS = ("image_u8", "joints", "aug_enabled", "noise_enabled")
BETA1 = 0.9  # Adam's first moment: exp_avg after step 1 is 0.1 x grad


class Probe:
    """Optimizer hooks that record, in the set-up's dispatches, each
    leaf's gradient norm at step 1 (from Adam's first moment) and each
    leaf's change from the start after step 3."""

    def __init__(self, state, start: dict):
        self.opt = state.optimizer
        self.named = list(state.model.named_parameters())
        self.start = start
        self.step = 0
        self.grad1 = self.change3 = None
        self.handle = self.opt.register_step_post_hook(self._hook)

    def _hook(self, opt, args, kwargs):
        self.step += 1
        with torch.no_grad():
            if self.step == 1:
                self.grad1 = ref_steps.leaf_norms(
                    opt.state[p]["exp_avg"] / (1 - BETA1)
                    for _, p in self.named)
            if self.step == 3:
                self.change3 = self.change()

    def change(self) -> torch.Tensor:
        return ref_steps.leaf_norms(p.detach() - self.start[n]
                                    for n, p in self.named)

    def close(self) -> None:
        self.handle.remove()


def _geometry(run):
    cfg = run.cell.config
    return dict(heatmap_size=cfg["heatmap_size"],
                stride=cfg["image_size"] / cfg["heatmap_size"],
                sigma=cfg["sigma"])


def setup(run) -> None:
    from lighthand_tpu_torch.train.step import make_fused_train_step

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    s = inputs.seeds(run.seed)
    run.pol = program.policy(mix["precision"])
    with torch.device("meta"):
        skeleton = ref_models.build(cfg)
    run.values = inputs.weights(skeleton, s.weights, dev)
    run.pool = inputs.pool(mix["batch"], cfg["image_size"], mix["aug_share"],
                           s, dev)
    run.mark("inputs")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.state = program.train_state(cfg, run.pol, run.values, mix["lr"], dev)
    run.step = make_fused_train_step(
        scan_steps=mix["scan_steps"], jitter=True, target_style="msra",
        compute_dtype=run.pol.compute_dtype, device=dev, **_geometry(run))
    run.generator = torch.Generator(device=dev).manual_seed(s.steps)
    run.mark("program")
    run.dispatches = 0
    probe = Probe(run.state, run.values)
    with program.numerics(run.pol):
        losses = [float(dispatch(run)) for _ in range(SETUP_DISPATCHES)]
    probe.close()
    run.kept = {"losses": losses, "grad1": probe.grad1,
                "change3": probe.change3, "change_setup": probe.change()}


def dispatch(run, traced: bool = False) -> torch.Tensor:
    """The next dispatch: the pool's next ``scan_steps`` microbatches
    stacked, then one call of the step; returns its loss (on the device)."""
    k, n = run.cell.mix["scan_steps"], inputs.POOL
    first = run.dispatches * k
    with trace.span("stack", traced):
        batch = {f: torch.stack([run.pool[f][(first + i) % n]
                                 for i in range(k)]) for f in FIELDS}
    with trace.span("step", traced):
        run.state, metrics = run.step(run.state, run.generator, batch)
    run.dispatches += 1
    return metrics["loss"]


def window(run) -> None:
    """Dispatches until ``seconds`` have passed, each loss read one
    dispatch late; the window ends when the last loss has been read."""
    mix = run.cell.mix
    losses, pending, n = [], None, 0
    with program.numerics(run.pol):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            loss = dispatch(run)
            n += 1
            if pending is not None:
                losses.append(float(pending))
            pending = loss
        losses.append(float(pending))
        elapsed = time.perf_counter() - t0
    run.attempted = n
    run.failed = sum(not math.isfinite(x) for x in losses)
    run.window_s = elapsed
    run.e2e = {"train_img_s": n * mix["scan_steps"] * mix["batch"] / elapsed}


def traced(run) -> trace.Summary:
    """``trace_dispatches`` more dispatches under the profiler, each loss
    read one dispatch late, as in the window."""
    def body():
        pending = None
        for _ in range(run.cell.mix["trace_dispatches"]):
            loss = dispatch(run, traced=True)
            if pending is not None:
                with trace.span("loss_read", True):
                    float(pending)
            pending = loss
        with trace.span("loss_read", True):
            float(pending)
        return run.cell.mix["trace_dispatches"] * run.cell.mix["scan_steps"]

    with program.numerics(run.pol):
        return trace.profile(body, run.device)


def finish(run) -> None:
    """Free the program's state, step and graphs; the judge reads only
    what set-up kept (its losses and norms)."""
    del run.state, run.step


def judge(run) -> Checks:
    """The reference follows the set-up's optimizer steps from the same
    weights, microbatches and draws; the program's set-up losses, first
    gradients and parameter changes are held against it, leaf by leaf:
    the worst leaf and the median leaf. The numbers the cell sets no limit
    for are readings only (the first gradient's worst leaf, the second
    dispatch's loss, each worst leaf's index). ``run.leaf_gaps`` keeps
    each leaf's gaps, by the reference's leaf names."""
    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    k = mix["scan_steps"]
    steps = SETUP_DISPATCHES * k
    mbs = [{f: run.pool[f][i % inputs.POOL] for f in FIELDS}
           for i in range(steps)]
    with torch.device("meta"):
        model = ref_models.build(cfg)
    model = ref_steps.load(model, run.values, dev)
    names = [n for n, _ in model.named_parameters()]
    got = ref_steps.follow_training(
        model, mbs, torch.Generator(device=dev).manual_seed(
            inputs.seeds(run.seed).steps),
        lr=mix["lr"], change_after=(3, steps),
        **_geometry(run))
    checks = Checks(run.cell.limits)
    ref_losses = got["losses"].double().reshape(SETUP_DISPATCHES, k).mean(1)
    gaps = [relative(p, float(r)) for p, r in zip(run.kept["losses"],
                                                    ref_losses)]
    checks.add("loss", max(gaps))
    checks.add("loss_first", gaps[0])
    keep = kept_leaves(got["grad1"])
    run.leaf_gaps = {"names": names}
    for name, prog, ref, kept in (
            ("grad1", run.kept["grad1"], got["grad1"], None),
            ("change3", run.kept["change3"], got["change"][3], keep),
            ("change_setup", run.kept["change_setup"], got["change"][steps],
             keep)):
        if prog is None:  # the optimizer never stepped so far
            for suffix in ("", "_median", "_leaf"):
                checks.add(name + suffix, float("nan"))
            continue
        gap = leaf_gaps(prog, ref, kept)
        run.leaf_gaps[name] = gap.tolist()
        worst, leaf = worst_leaf(gap)
        checks.add(name, worst)
        checks.add(f"{name}_median", median_leaf(gap, kept))
        checks.add(f"{name}_leaf", leaf)
    return checks
