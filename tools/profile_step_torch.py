#!/usr/bin/env python3
"""Capture and summarize a ``torch.profiler`` trace of the port's bench
train step on one NVIDIA GPU: the counterpart of ``tools/profile_step.py``.

Runs ``bench_torch``'s workload (HRNet-W32@256 bs128 bf16, 4 microbatches
a dispatch, by default) under ``lighthand_tpu_torch/train/profiler.py:
trace`` after a few warm-up dispatches, which writes ``{out}/trace.json``
(Chrome trace format), with CUDA events around the profiled dispatches in
``{out}/window.json``. Then it ranks the CUDA kernels (``cat ==
"kernel"``) by total device ms a dispatch, with share and count, collapsing
instance suffixes as ``tools/profile_step.py:summarize`` does.

XLA's trace carries ``bytes_accessed`` and ``model_flops`` per op, from
which the JAX tool builds a roofline per HLO category; torch's trace
carries neither. So the kernels are grouped into name families instead
(``FAMILIES``: the port's own kernels, BatchNorm, cuDNN/cuBLAS conv and
gemm, the optimizer, reductions, elementwise/cast/copy, the rest), each
with its ms and count a dispatch.

The bench's step runs as CUDA graphs (``train/graph.py``): after the
warm-up dispatches (the first eager, the second capturing), each
microbatch is one ``cudaGraphLaunch``, whose kernels all carry that
launch's correlation id, and Adam's kernels are launched one by one.

The profiler can drop kernel events. The summary prints the profiled
kernel sum against the CUDA-event time of the same dispatches (their ratio
is the device's busy share as the profiler sees it: idle gaps lower it as
dropped events do), and the share of launch calls in the trace
(``cuda_runtime`` / ``cuda_driver`` kernel and graph launch events) that a
kernel event answers by its correlation id: a kernel launch by its
kernel, a graph launch by the kernels of its replay (their count a graph
launch is printed). Each launch left unanswered is a dropped event, and
the summary says how many; a window where fewer than 0.95 of the launches
are answered has kernel sums that are not device time.

Each idle gap between device operations (kernels, copies, fills) is
labelled by the host call that launched the operation ending it:
``queued`` where that call had returned before the gap began (a bubble in
work already on the stream, such as between the kernels of a replayed
graph), otherwise the innermost program span (``lighthand.*``,
``train/profiler.py:annotate``) or optimizer range (``Optimizer.step#``)
that holds the call, or ``other host work``.

Usage:
    python3 tools/profile_step_torch.py [--model hrnet_w32] [--batch 128]
        [--size 256] [--steps 6] [--scan 4] [--precision bf16]
        [--out lh_trace_torch] [--parse-only] [--per-op]

``--parse-only`` summarizes an existing ``--out``; ``--per-op`` also ranks
the launching CPU operation of each kernel (the attribution view). The
default output directory lies in the repository and is git-ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
from collections import defaultdict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from lighthand_tpu_torch.core.dtypes import numerics  # noqa: E402
from lighthand_tpu_torch.train.profiler import trace  # noqa: E402

DEFAULT_OUT = os.path.join(REPO, "lh_trace_torch")
DROP_FLAG = 0.95

# (family, pattern on the kernel's name); the first match wins
FAMILIES = (
    ("port kernels", r"fused_aug|heatmap_targets|int8_conv|quantize_weights"
                     r"|raster_"),
    ("batch norm", r"batch_norm|batchnorm|bn_fw|bn_bw|welford"),
    ("optimizer", r"multi_tensor|adam"),
    ("conv / gemm (cuDNN, cuBLAS)", r"conv(?!ert)|dgrad|wgrad|fprop|gemm"
                                    r"|xmma|cutlass|cudnn|cublas|winograd"),
    ("elementwise / cast / copy", r"elementwise|copy|cast|fill"),
    ("reduction", r"reduce"),
    ("other", r""),
)
_LAUNCH = re.compile(r"Launch(Kernel|CooperativeKernel)|cuLaunch")
_GRAPH_LAUNCH = re.compile(r"GraphLaunch")
# the trace's work on the device, and the host ranges that label its gaps
# (the program's spans are cpu_op events, torch's optimizer ranges
# user annotations)
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_RANGE = re.compile(r"^(lighthand\.|Optimizer\.step#)")


def run_workload(model_name: str, batch: int, size: int, out_dir: str,
                 steps: int = 6, precision: str = "bf16",
                 scan_steps: int = 4, warmup: int = 3, device=None) -> dict:
    """``warmup`` dispatches of ``bench_torch.setup``'s workload outside the
    trace, then ``trace_workload``'s ``steps`` dispatches inside it."""
    wl = bench_torch.setup(model_name, batch, size, precision, scan_steps,
                           device=device)
    with numerics(wl.policy):
        for _ in range(warmup):
            wl.dispatch()
    return trace_workload(wl, out_dir, steps, {
        "model": model_name, "batch": batch, "size": size,
        "precision": precision, "scan_steps": scan_steps})


def trace_workload(wl, out_dir: str, steps: int, info: dict) -> dict:
    """``steps`` dispatches of the warm workload ``wl`` inside ``trace``,
    synchronised before the trace closes, with CUDA events around them;
    writes and returns ``{out_dir}/window.json`` (``info`` and the
    window's figures)."""
    cuda = wl.device.type == "cuda"
    with numerics(wl.policy):
        if cuda:
            torch.cuda.synchronize(wl.device)
        with trace(out_dir):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = wl.dispatch()
            if cuda:
                end.record()
                torch.cuda.synchronize(wl.device)
            wall_ms = (time.perf_counter() - t0) * 1e3
    window = {**info, "dispatches": steps, "wall_ms": wall_ms,
              "graphed": wl.step.graphs is not None,
              "event_ms": start.elapsed_time(end) if cuda else None,
              "loss": float(loss)}
    with open(os.path.join(out_dir, "window.json"), "w") as f:
        json.dump(window, f)
    return window


def family(name: str) -> str:
    low = name.lower()
    return next(f for f, pat in FAMILIES if re.search(pat, low))


def collapse(name: str) -> str:
    """``tools/profile_step.py``'s collapse: ``fusion.123`` -> ``fusion``."""
    return re.sub(r"[.\-]\d+$", "", name.lstrip("%"))


def _short(name: str, width: int = 110) -> str:
    return name if len(name) <= width else name[:width - 3] + "..."


def _cause(gap_start: float, call, ranges) -> str:
    """The label of a gap that began at ``gap_start`` and ends at an
    operation launched by the host call ``call`` (start, end; None if the
    trace lacks it)."""
    if call is None:
        return "no launch event"
    if call[1] <= gap_start:
        return "queued"
    holding = [(hi - lo, name) for lo, hi, name in ranges
               if lo <= call[0] and call[1] <= hi]
    return min(holding)[1] if holding else "other host work"


def idle_gaps(events) -> dict:
    """{label: idle us} of a trace's gaps between device operations, each
    labelled by the launch of the operation that ends it (``_cause``)."""
    ops, calls, ranges = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, args = e.get("cat"), e.get("args", {})
        span = (e["ts"], e["ts"] + e["dur"])
        if cat in DEVICE_OPS:
            ops.append(span + (args.get("correlation"),))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            calls[args["correlation"]] = span
        elif (cat in ("user_annotation", "cpu_op")
              and _RANGE.search(e.get("name", ""))):
            ranges.append(span + (e["name"],))
    gaps, end = defaultdict(float), None
    for lo, hi, corr in sorted(ops, key=lambda op: op[:2]):
        if end is not None and lo > end:
            gaps[_cause(end, calls.get(corr), ranges)] += lo - end
        end = hi if end is None else max(end, hi)
    return dict(gaps)


def summarize(out_dir: str, top_k: int = 30, per_op: bool = False) -> dict:
    """Rank the trace's CUDA kernels by device ms a dispatch; group them by
    family; set their sum against the window's CUDA events and count the
    launch calls no kernel event answers; prints the ``top_k`` kernels.
    Returns the figures a dispatch (``rows``: the whole ranking;
    ``families``, ``kernel_ms``, ``event_ms``, ``busy``, ``launches``,
    ``matched``, ``dropped``: launches no kernel event answers,
    ``kernels``; ``idle``: idle ms by ``idle_gaps``' label;
    ``graph_launches`` and ``graph_kernels``, the kernel events that
    answer them, over the window), or {} without a trace."""
    path = os.path.join(out_dir, "trace.json")
    if not os.path.isfile(path):
        print(f"no trace found under {out_dir}", file=sys.stderr)
        return {}
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = {}
    if os.path.isfile(os.path.join(out_dir, "window.json")):
        with open(os.path.join(out_dir, "window.json")) as f:
            window = json.load(f)
    n = max(int(window.get("dispatches", 1)), 1)

    totals, counts = defaultdict(float), defaultdict(int)
    fam_us, fam_n = defaultdict(float), defaultdict(int)
    op_us, op_n = defaultdict(float), defaultdict(int)
    kernel_corr, launch_corr, graph_corr = set(), set(), set()
    kernels_by_corr = defaultdict(int)
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    for e in events:
        cat, args = e.get("cat"), e.get("args", {})
        if cat in ("cuda_runtime", "cuda_driver") and _LAUNCH.search(
                e.get("name", "")) and "correlation" in args:
            launch_corr.add(args["correlation"])
        if cat in ("cuda_runtime", "cuda_driver") and _GRAPH_LAUNCH.search(
                e.get("name", "")) and "correlation" in args:
            graph_corr.add(args["correlation"])
        if e.get("ph") != "X" or cat != "kernel" or "dur" not in e:
            continue
        name = collapse(e.get("name", "?"))
        totals[name] += e["dur"]
        counts[name] += 1
        fam_us[family(name)] += e["dur"]
        fam_n[family(name)] += 1
        if "correlation" in args:
            kernel_corr.add(args["correlation"])
            kernels_by_corr[args["correlation"]] += 1
        if per_op:
            op = ops.get(args.get("External id"), "?")
            op_us[op] += e["dur"]
            op_n[op] += 1

    total = sum(totals.values())
    kernel_ms = total / 1e3 / n
    print(f"trace: {path}")
    if window:
        print(f"window: {n} dispatches of {window['model']} bs"
              f"{window['batch']} @{window['size']} {window['precision']}, "
              f"{window['scan_steps']} steps each; host "
              f"{window['wall_ms'] / n:.2f} ms a dispatch")
    rows = [{"op": name, "ms": us / 1e3 / n,
             "pct": 100.0 * us / total if total else 0.0,
             "count": counts[name]}
            for name, us in sorted(totals.items(), key=lambda kv: -kv[1])]
    for r in rows[:top_k]:
        print(f"{r['pct']:5.1f}%  {r['ms']:9.3f} ms  x{r['count']:<6d} "
              f"{_short(r['op'])}")
    families = {f: {"ms": fam_us[f] / 1e3 / n, "count": fam_n[f] / n,
                    "pct": 100.0 * fam_us[f] / total if total else 0.0}
                for f, _ in FAMILIES if fam_n[f]}
    print(f"by family (a dispatch; kernel total {kernel_ms:.3f} ms):")
    for f, v in sorted(families.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {v['pct']:5.1f}%  {v['ms']:9.3f} ms  x{v['count']:<8.1f} "
              f"{f}")
    if per_op:
        print("\nby launching CPU operation (attribution):")
        for op, us in sorted(op_us.items(), key=lambda kv: -kv[1])[:top_k]:
            pct = 100.0 * us / total if total else 0.0
            print(f"{pct:5.1f}%  {us / 1e3 / n:9.3f} ms  x{op_n[op]:<6d} "
                  f"{_short(op)}")

    event_ms = window.get("event_ms")
    busy = None
    if event_ms:
        busy = kernel_ms / (event_ms / n)
        print(f"profiled kernel sum {kernel_ms:.3f} ms a dispatch against "
              f"{event_ms / n:.3f} ms of CUDA events: ratio {busy:.4f} (the "
              "busy share the profiler sees; idle gaps lower it too)")
    graph_kernels = sum(kernels_by_corr[c] for c in graph_corr)
    if graph_corr:
        print(f"graph launches: {len(graph_corr)}, answered by "
              f"{len(graph_corr & kernel_corr)}, carrying {graph_kernels} "
              f"kernel events ({graph_kernels / len(graph_corr):.1f} a "
              "launch)")
    launch_corr |= graph_corr
    matched = len(launch_corr & kernel_corr)
    dropped = len(launch_corr) - matched
    if launch_corr:
        share = matched / len(launch_corr)
        note = ""
        if dropped:
            note = (f"  DROPPED EVENTS: {dropped} kernels missing; "
                    + ("the kernel sums are not device time"
                       if share < DROP_FLAG
                       else "the sums are low by up to that share"))
        print(f"launch calls answered by a kernel event: {matched} of "
              f"{len(launch_corr)} ({share:.4f}){note}")
    idle = {label: us / 1e3 / n for label, us in sorted(
        idle_gaps(events).items(), key=lambda kv: -kv[1])}
    if idle:
        print(f"idle between device operations, {sum(idle.values()):.3f} "
              "ms a dispatch, by the launch that ends each gap:")
        for label, ms in idle.items():
            print(f"  {ms:9.3f} ms  {label}")
    return {"rows": rows, "families": families, "kernel_ms": kernel_ms,
            "event_ms": None if event_ms is None else event_ms / n,
            "busy": busy, "launches": len(launch_corr), "matched": matched,
            "dropped": dropped, "kernels": sum(counts.values()) / n,
            "idle": idle, "graph_launches": len(graph_corr),
            "graph_kernels": graph_kernels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="hrnet_w32")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--scan", type=int, default=4)
    p.add_argument("--precision", default="bf16")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--parse-only", action="store_true")
    p.add_argument("--per-op", action="store_true",
                   help="also rank each kernel's launching CPU operation")
    a = p.parse_args(argv)
    if not a.parse_only:
        print(f"# {bench_torch.card_line()}", flush=True)
        run_workload(a.model, a.batch, a.size, a.out, a.steps, a.precision,
                     a.scan)
    summarize(a.out, per_op=a.per_op)
    return 0


if __name__ == "__main__":
    sys.exit(main())
