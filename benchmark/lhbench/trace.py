"""A profiled sub-window, read in memory: ``torch.profiler``'s events
(no Chrome trace is written), the device's busy time, the idle gaps
labelled by what the host was doing, kernel time by name and family, the
host ranges, and the share of launches that a kernel event answers.

``FAMILIES``, ``family``, ``collapse`` and the answered-launch rule are
copied from ``tools/profile_step_torch.py``, frozen here so that a later
change to the program cannot move them. The "attention" and "layer norm"
families are the benchmark's own, ahead of "conv / gemm", which would
otherwise take flash attention's ``cutlass::`` templates and cuDNN's SDPA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

# (family, pattern on the kernel's name); the first match wins
FAMILIES = (
    ("port kernels", r"fused_aug|heatmap_targets|int8_conv|quantize_weights"
                     r"|raster_"),
    ("batch norm", r"batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("optimizer", r"multi_tensor|adam"),
    ("attention", r"flash_fwd|flash_bwd|fmha|sdpa|attention"),
    ("layer norm", r"layer_norm|layernorm|gammabetabackward"),
    ("conv / gemm (cuDNN, cuBLAS)", r"conv(?!ert)|dgrad|wgrad|fprop|gemm"
                                    r"|xmma|cutlass|cudnn|cublas|winograd"),
    ("elementwise / cast / copy", r"elementwise|copy|cast|fill"),
    ("reduction", r"reduce"),
    ("other", r""),
)
ANSWERED_FLOOR = 0.95  # below it the kernel sums are not device time
# the profiler's activities that are work on the device (its
# "gpu_user_annotation" events only mirror host ranges onto the device's
# timeline, and are no work)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = re.compile(r"Launch(Kernel|CooperativeKernel)|cuLaunch")
_GRAPH_LAUNCH = re.compile(r"GraphLaunch")
SPAN_PREFIX = "lhbench."  # the harness's own host ranges
_RANGE = re.compile(r"^(lhbench\.|Optimizer\.step#)")


def family(name: str) -> str:
    low = name.lower()
    return next(f for f, pat in FAMILIES if re.search(pat, low))


def collapse(name: str) -> str:
    """``fusion.123`` -> ``fusion``."""
    return re.sub(r"[.\-]\d+$", "", name.lstrip("%"))


def span(name: str, on: bool):
    """A host range named ``lhbench.<name>`` inside a profiled window, a
    no-op outside one."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class Summary:
    """What a profiled sub-window of ``units`` microbatches (or batches)
    showed. Times in seconds."""
    units: int
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]  # collapsed name: (s, launches)
    families: Dict[str, float]
    ranges: Dict[str, Tuple[float, int]]  # host range: (s, count)
    gaps: List[Tuple[str, float]]  # (host range or "edges", idle s), summed
    launches: int
    answered: int
    graph_launches: int

    @property
    def answered_share(self) -> float:
        return self.answered / self.launches if self.launches else 1.0

    def kernel_s(self, pattern: str) -> Tuple[float, int]:
        """(device s, launches) of the kernels whose name matches."""
        hits = [v for k, v in self.kernels.items() if re.search(pattern, k)]
        return sum(s for s, _ in hits), sum(n for _, n in hits)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _label(t: int, ranges: List[Tuple[int, int, str]]) -> str:
    """The innermost harness or optimizer range that holds time ``t`` (a
    gap's midpoint)."""
    best = None
    for lo, hi, name in ranges:
        if lo <= t < hi and (best is None or hi - lo < best[1] - best[0]):
            best = (lo, hi, name)
    return best[2] if best else "other host work"


def activity(e) -> str:
    """The profiler's activity of an event, worked out from its device, its
    name and its user-annotation flag: on the device, a mirrored host
    range, a copy or fill, or a kernel; on the host, a range or a runtime
    call."""
    name = e.name()
    annotation = (getattr(e, "is_user_annotation", lambda: False)()
                  or bool(_RANGE.search(name)))
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def profile(fn: Callable[[], int], device: torch.device) -> Summary:
    """Run ``fn`` (which returns how many microbatches or batches it ran)
    under ``torch.profiler`` with CUDA events around it, and read the
    events."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        units = fn()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
    window_s = start.elapsed_time(end) / 1e3 if cuda else 0.0
    return read(prof.profiler.kineto_results.events(), window_s, units)


def read(events, window_s: float, units: int) -> Summary:
    """The summary of a window's profiler events (torch's kineto events:
    ``name``, ``start_ns``, ``duration_ns``, ``correlation_id`` and what
    ``activity`` reads) over ``window_s`` seconds of ``units`` units."""
    device_iv, kernels = [], defaultdict(lambda: [0.0, 0])
    fams = defaultdict(float)
    ranges, host = [], defaultdict(lambda: [0.0, 0])
    kernel_corr, launch_corr, graph_corr = set(), set(), set()
    for e in events:
        name, lo, dur = e.name(), e.start_ns(), e.duration_ns()
        act = activity(e)
        if act in DEVICE_OPS:
            device_iv.append((lo, lo + dur))
            if act != "kernel":
                continue
            key = collapse(name)
            kernels[key][0] += dur / 1e9
            kernels[key][1] += 1
            fams[family(key)] += dur / 1e9
            kernel_corr.add(e.correlation_id())
        elif act == "user_annotation" and _RANGE.search(name):
            ranges.append((lo, lo + dur, name))
            host[name][0] += dur / 1e9
            host[name][1] += 1
        elif act in ("cuda_runtime", "cuda_driver"):
            if _GRAPH_LAUNCH.search(name):
                graph_corr.add(e.correlation_id())
            elif _LAUNCH.search(name):
                launch_corr.add(e.correlation_id())

    busy = _union(device_iv)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e9
    gaps = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        gaps[_label((a + b) // 2, ranges)] += (b - a) / 1e9
    if busy:
        gaps["edges"] += max(0.0, window_s - (busy[-1][1] - busy[0][0]) / 1e9)
    launch_corr |= graph_corr
    return Summary(
        units=units, window_s=window_s, busy_s=busy_s,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        families=dict(fams),
        ranges={k: (v[0], v[1]) for k, v in host.items()},
        gaps=sorted(gaps.items(), key=lambda kv: -kv[1]),
        launches=len(launch_corr), answered=len(launch_corr & kernel_corr),
        graph_launches=len(graph_corr))


def breakdown(s: Summary) -> dict:
    """The result line's ``breakdown``: the device operation families and
    the idle gaps by host range, the ten largest of each, in seconds over
    the profiled window."""
    ops = sorted(s.families.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in s.gaps[:10]]}


def notes(s: Summary) -> List[str]:
    """The ``#`` lines of a traced run."""
    share = s.answered_share
    lines = [f"launches answered by a kernel event: {s.answered} of "
             f"{s.launches} ({share:.4f})"
             + ("" if share >= ANSWERED_FLOOR else
                "; below 0.95: the kernel sums are not device time"),
             f"profiled window {s.window_s:.6f} s over {s.units} units, "
             f"device busy {s.busy_s:.6f} s; graph launches "
             f"{s.graph_launches / max(s.units, 1):.2f} and kernel launches "
             f"{sum(n for _, n in s.kernels.values()) / max(s.units, 1):.1f}"
             " a unit"]
    for label, sec in s.gaps[:5]:
        lines.append(f"idle gap: {sec * 1e3:.3f} ms during {label}")
    return lines
