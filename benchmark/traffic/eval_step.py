"""Traffic of the kind ``eval_step``: the validation loop
(``train/loop.py:run_valid_epoch``, which ``cli.train`` runs every epoch
and whose step ``cli.eval`` serves) over device batches, a closed loop.

Each batch goes through ``data/pipeline.py:preprocess_u8`` and then
``make_eval_step`` (K2's targets, the forward in eval mode, the argmax
decode, the loss, PCK and EPE sums); its six sums come to the host in one
``torch.stack(...).tolist()``. The pool is ``inputs.POOL`` seeded batches
on the device; ``valid`` is all 1.

The weights are seeded, and every BatchNorm's running statistics are set
at set-up to those of a calibration batch in the reference's f32 forward
(a model that never trained would otherwise carry its layers' raw scale
into the heatmaps); the program and the reference receive the same. That
forward is the reference's work, and its seconds are kept out of
``setup_s``. Set-up runs two batches (the first eager, the second
captures the step's graph) before the window.

The reference computes at the precision the mix states: f32 for bf16 and
f32, and for int8_fwd the same f32 model with its backbone convs on int8
operands, quantized as the int8_fwd policy states (``REFERENCE_BITS``;
per-output-channel weights, activations clipped at 8). Under int8_fwd the
gaps to the plain f32 model are kept as readings (``loss_f32``,
``joints_mean_f32``).

A mix's parameters: ``batch``, ``precision``, ``pck_t``,
``calibration_images``, ``trace_batches``.
"""

from __future__ import annotations

import math
import time

import torch

from lhbench import inputs, program, trace
from lhbench.judge import Checks
from reference import aug as ref_aug
from reference import models as ref_models
from reference import steps as ref_steps

SETUP_BATCHES = 2
# the reference's fake-quantized bits under a mix's stated precision
REFERENCE_BITS = {"int8_fwd": 8}
SUMS = ("loss_sum", "n_valid", "pck_sum", "pck_count", "epe_sum",
        "epe_count")


def _geometry(run):
    cfg = run.cell.config
    return dict(heatmap_size=cfg["heatmap_size"],
                stride=cfg["image_size"] / cfg["heatmap_size"],
                sigma=cfg["sigma"])


def reference_model(run, **quant):
    """The reference model with the run's weights and calibrated
    statistics on the device (``quant``: ``reference.models.build``'s)."""
    with torch.device("meta"):
        model = ref_models.build(run.cell.config, **quant)
    return ref_steps.load(model, run.values, run.device)


def setup(run) -> None:
    from lighthand_tpu_torch.train.step import make_eval_step

    cfg, mix, dev = run.cell.config, run.cell.mix, run.device
    s = inputs.seeds(run.seed)
    run.pol = program.policy(mix["precision"])
    with torch.device("meta"):
        skeleton = ref_models.build(cfg)
    run.values = inputs.weights(skeleton, s.weights, dev)
    run.pool = inputs.pool(mix["batch"], cfg["image_size"], 0.0, s, dev)
    # load cuDNN here, as the program's first conv would, so that the
    # reference's calibration below does not take that off set-up
    torch.nn.functional.conv2d(torch.ones(1, 1, 4, 4, device=dev),
                               torch.ones(1, 1, 1, 1, device=dev))
    run.mark("inputs")
    t0 = time.perf_counter()
    ref = reference_model(run)
    ref_steps.calibrate(ref, run.pool["image_u8"][0][
        :mix["calibration_images"]])
    stats = ref.state_dict()
    run.values.update({n: stats[n].clone() for n in run.values
                       if n.endswith(("running_mean", "running_var"))})
    del ref, stats
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.reference_s += time.perf_counter() - t0
    run.mark("calibration (reference, not in setup_s)")
    run.valid = torch.ones(mix["batch"], device=dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    run.state = program.train_state(cfg, run.pol, run.values, 1e-3, dev)
    run.step = make_eval_step(pck_t=mix["pck_t"], target_style="msra",
                              device=dev, **_geometry(run))
    run.batches = 0
    run.mark("program")
    with program.numerics(run.pol):
        for _ in range(SETUP_BATCHES):
            batch(run)


def batch(run, traced: bool = False):
    """The next pool batch through the preprocess and the eval step, its
    sums read on the host: (pool index, the six sums, pred_joints on the
    device)."""
    from lighthand_tpu_torch.data.pipeline import preprocess_u8

    i = run.batches % inputs.POOL
    with trace.span("preprocess", traced):
        images = preprocess_u8(run.pool["image_u8"][i],
                               run.pol.compute_dtype)
    with trace.span("step", traced):
        m = run.step(run.state, {"image": images,
                                 "joints": run.pool["joints"][i],
                                 "valid": run.valid, "hm_max": None})
    with trace.span("read_sums", traced):
        sums = torch.stack([m[k] for k in SUMS]).tolist()
    run.batches += 1
    return i, sums, m["pred_joints"]


def window(run) -> None:
    """Batches until ``seconds`` have passed; each batch's host time from
    the preprocess call to its sums on the host."""
    answers, times = [], []
    with program.numerics(run.pol):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            b0 = time.perf_counter()
            answers.append(batch(run))
            times.append(time.perf_counter() - b0)
        elapsed = time.perf_counter() - t0
    times.sort()
    p95 = times[math.ceil(0.95 * len(times)) - 1]
    run.answers = answers
    run.attempted = len(answers)
    run.window_s = elapsed
    run.e2e = {"eval_img_s": len(answers) * run.cell.mix["batch"] / elapsed,
               "eval_batch_ms_p95": p95 * 1e3}


def traced(run) -> trace.Summary:
    """``trace_batches`` more batches under the profiler."""
    def body():
        for _ in range(run.cell.mix["trace_batches"]):
            batch(run, traced=True)
        return run.cell.mix["trace_batches"]

    with program.numerics(run.pol):
        return trace.profile(body, run.device)


def finish(run) -> None:
    """Free the program's state, step and graphs; the window's answers
    stay for the judge."""
    del run.state, run.step


def reference_answers(run, model) -> dict:
    """The reference's loss sum and heatmaps of every pool batch."""
    geo = _geometry(run)
    return {i: ref_steps.evaluate(model, run.pool["image_u8"][i],
                                  run.pool["joints"][i], **geo)
            for i in range(inputs.POOL)}


def gaps(heatmaps: torch.Tensor, pred_px: torch.Tensor,
         stride: float) -> torch.Tensor:
    """How far below the reference map's maximum the reference's value at
    the program's decoded joint lies, in units of that map's standard
    deviation: ``heatmaps`` [B, J, H, W], ``pred_px`` [..., B, J, 2] ->
    [..., B, J]. A joint decoded as (0, 0) may also mean the program found
    no positive value: it then counts the lower of the two readings."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, h * w)
    top = flat.amax(-1)
    xy = torch.round(pred_px / stride).long()
    idx = xy[..., 1].clamp(0, h - 1) * w + xy[..., 0].clamp(0, w - 1)
    at = flat[torch.arange(b, device=flat.device)[:, None],
              torch.arange(j, device=flat.device)[None, :], idx]
    gap = top - at
    zero = (pred_px == 0).all(-1)
    gap = torch.where(zero, torch.minimum(gap, torch.clamp_min(top, 0)), gap)
    return gap / flat.std(-1)


def sums_gap(sums: torch.Tensor, pred: torch.Tensor, joints: torch.Tensor,
             mix: dict) -> torch.Tensor:
    """Each answer's worst departure of its sums from the reference's
    metrics of its own decoded joints: the counts (valid rows, PCK hits
    and joints, EPE joints) must be exact; the EPE sum may differ only by
    the round-off of an f32 sum of its n terms in another order (n x 2^-24
    of the sum), and the number is what lies beyond that, relative."""
    pck, pck_n, epe, epe_n = ref_aug.metric_sums(pred, joints, mix["pck_t"])
    epe = torch.as_tensor(epe, dtype=torch.float64).cpu()
    counts = torch.stack([
        (sums[:, 1] - mix["batch"]).abs(),
        (sums[:, 2] - torch.as_tensor(pck, dtype=torch.float64).cpu()).abs(),
        (sums[:, 3] - pck_n).abs(), (sums[:, 5] - epe_n).abs()]).amax(0)
    slack = epe_n * 2.0 ** -24 * epe
    beyond = torch.clamp_min((sums[:, 4] - epe).abs() - slack, 0)
    return torch.maximum(counts, beyond / torch.clamp_min(epe, 1e-30))


def compare(run, answers, refs, limits: dict) -> tuple:
    """(the worst of each number over ``answers``, how many answers are
    over a limit of ``limits``) against the reference's ``refs``: the
    loss sum (relative gap), the decoded joints (``gaps``: the widest and
    the batch's mean), and the PCK and EPE sums and counts against the
    reference's metrics of the program's own joints (``sums_gap``)."""
    mix, stride = run.cell.mix, _geometry(run)["stride"]
    worst = {k: 0.0 for k in ("loss", "joints", "joints_mean", "sums")}
    failed = 0
    for i in range(inputs.POOL):
        mine = [(sums, pred) for k, sums, pred in answers if k == i]
        if not mine:
            continue
        sums = torch.tensor([s for s, _ in mine], dtype=torch.float64)
        pred = torch.stack([p.float() for _, p in mine])
        ref_loss = float(refs[i]["loss_sum"])
        heat = gaps(refs[i]["heatmaps"], pred, stride).double().cpu()
        row = {"loss": (sums[:, 0] - ref_loss).abs()
               / max(abs(ref_loss), 1e-30),
               "joints": heat.amax(dim=(1, 2)),
               "joints_mean": heat.mean(dim=(1, 2)),
               "sums": sums_gap(sums, pred, run.pool["joints"][i], mix)}
        over = torch.zeros(len(mine), dtype=torch.bool)
        for k, v in row.items():
            if k in limits:
                over |= torch.isnan(v) | (v > limits[k])
            worst[k] = (float("nan") if torch.isnan(v).any()
                        or math.isnan(worst[k]) else max(worst[k],
                                                         float(v.max())))
        failed += int(over.sum())
    return worst, failed


def judge(run, answers=None) -> Checks:
    """Every answer of the window against the reference's at the mix's
    stated precision (``compare``); under int8_fwd also against the plain
    f32 model, as readings. ``answers`` stand in for the window's in a
    control run. The numbers the cell sets no limit for are readings only
    (the widest joint gap; the joints' mean where no number
    separates)."""
    answers = run.answers if answers is None else answers
    bits = REFERENCE_BITS.get(run.cell.mix["precision"])
    refs = reference_answers(run, reference_model(run, quant_bits=bits))
    worst, run.failed = compare(run, answers, refs, run.cell.limits)
    checks = Checks(run.cell.limits)
    for k, v in worst.items():
        checks.add(k, v)
    if bits is not None:
        refs = reference_answers(run, reference_model(run))
        worst, _ = compare(run, answers, refs, {})
        checks.add("loss_f32", worst["loss"])
        checks.add("joints_mean_f32", worst["joints_mean"])
    return checks


def control_answers(run, bits: int) -> list:
    """The answers of the reference with its backbone convs at ``bits``
    bits, put in the program's place: one a pool batch, its sums worked
    out from its own decoded joints."""
    model = reference_model(run, quant_bits=bits)
    mix, stride = run.cell.mix, _geometry(run)["stride"]
    answers = []
    for i, got in reference_answers(run, model).items():
        pred = ref_aug.decode(got["heatmaps"])[0] * stride
        pck, pck_n, epe, epe_n = ref_aug.metric_sums(
            pred, run.pool["joints"][i], mix["pck_t"])
        answers.append((i, [float(got["loss_sum"]), float(mix["batch"]),
                            float(pck), pck_n, float(epe), epe_n], pred))
    return answers
