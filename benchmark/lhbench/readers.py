"""What the per-layer metrics' readers (``metrics/<name>.py``) share:
each takes a finished ``Run`` and returns a number, or None where its
cells' trace holds nothing to read."""

from __future__ import annotations

import re

import torch

from lhbench import yardstick

OPTIMIZER_RANGE = re.compile(r"^Optimizer\.step#\w+\.step$")
K1_KERNEL = r"fused_aug(_groups)?_kernel"
K2_KERNEL = r"heatmap_targets_kernel"
INT8_KERNELS = r"int8_conv|quantize_weights_kernel"


def idle_share(run):
    """% of the profiled sub-window in which no operation ran on the
    device."""
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(run, rate_key: str, flops_per_image: float):
    """% of the card's bf16 dense peak that ``flops_per_image`` at the
    window's rate ``run.e2e[rate_key]`` (images/s) is."""
    if rate_key not in run.e2e:
        return None
    return (100.0 * flops_per_image * run.e2e[rate_key]
            / yardstick.MFU_PEAK_FLOPS)


def device_ms_per_unit(run, pattern: str | None = None,
                       family: str | None = None):
    """Device ms a microbatch (or batch) of the kernels whose name matches
    ``pattern``, or of a kernel ``family``; None where none ran."""
    s = run.summary
    if s is None or not s.units:
        return None
    if family is not None:
        seconds = s.families.get(family)
        return None if not seconds else seconds * 1e3 / s.units
    seconds, launches = s.kernel_s(pattern)
    return None if not launches else seconds * 1e3 / s.units


def host_ms_per_unit(run, pattern: re.Pattern):
    """Host ms a microbatch (or batch) inside the ranges named by
    ``pattern``."""
    s = run.summary
    if s is None or not s.units:
        return None
    hits = [sec for name, (sec, _) in s.ranges.items() if pattern.search(name)]
    return None if not hits else sum(hits) * 1e3 / s.units


def roofline(run, pattern: str, work: tuple):
    """% of its least time on the card (``work`` = (bytes, f32 ops)) that
    a kernel's mean device time a launch is."""
    s = run.summary
    if s is None:
        return None
    seconds, launches = s.kernel_s(pattern)
    if not launches or seconds <= 0:
        return None
    kind = torch.cuda.get_device_name(run.device)
    return 100.0 * yardstick.bound_s(*work, kind) / (seconds / launches)
