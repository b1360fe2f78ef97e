"""The reading of a profiled window: device busy time and idle gaps,
kernel families, host ranges, answered launches, from synthetic events
(the card's events exist only on the card)."""

from __future__ import annotations

import dataclasses

import pytest

from lhbench import readers, trace


@dataclasses.dataclass
class Event:
    _name: str
    _act: str
    _start: int
    _dur: int
    _corr: int = 0

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return "user_annotation" in self._act

    def device_type(self):
        import torch

        return (torch.autograd.DeviceType.CUDA
                if self._act.startswith(("kernel", "gpu_"))
                else torch.autograd.DeviceType.CPU)


MS = 1_000_000
EVENTS = [
    Event("lhbench.step", "user_annotation", 0, 10 * MS),
    Event("lhbench.step", "gpu_user_annotation", 0, 10 * MS),
    Event("cudaGraphLaunch", "cuda_runtime", 0, MS, 1),
    Event("cudnn_batch_norm_fwd_kernel", "kernel", 1 * MS, 3 * MS, 1),
    Event("sm90_xmma_fprop_implicit_gemm", "kernel", 2 * MS, 3 * MS, 1),
    Event("Optimizer.step#ShardAdam.step", "user_annotation", 6 * MS, 3 * MS),
    Event("cudaLaunchKernel", "cuda_runtime", 6 * MS, MS, 2),
    Event("fused_aug_kernel", "kernel", 8 * MS, 1 * MS, 2),
    Event("cudaLaunchKernel", "cuda_runtime", 9 * MS, MS, 3),
    Event("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 9 * MS, MS, 4),
]


def test_window_reading():
    s = trace.read(EVENTS, 0.012, 2)
    # device work covers 1-5 ms and 8-10 ms; the mirrored host range is
    # no work
    assert s.busy_s == pytest.approx(0.006)
    assert dict(s.gaps)["Optimizer.step#ShardAdam.step"] == \
        pytest.approx(0.003)
    assert dict(s.gaps)["edges"] == pytest.approx(0.012 - 0.009)
    assert s.families["batch norm"] == pytest.approx(0.003)
    assert s.families["port kernels"] == pytest.approx(0.001)
    assert "other" not in s.families
    assert s.launches == 3 and s.answered == 2 and s.graph_launches == 1
    assert s.ranges["Optimizer.step#ShardAdam.step"] == \
        pytest.approx((0.003, 1))
    assert s.kernel_s(readers.K1_KERNEL) == pytest.approx((0.001, 1))


def test_activity_of_each_event():
    assert [trace.activity(e) for e in EVENTS] == [e._act for e in EVENTS]


def test_readers_of_a_window():
    class Run:
        summary = trace.read(EVENTS, 0.012, 2)
    assert readers.idle_share(Run) == pytest.approx(50.0)
    assert readers.device_ms_per_unit(Run, family="batch norm") == \
        pytest.approx(1.5)
    assert readers.host_ms_per_unit(Run, readers.OPTIMIZER_RANGE) == \
        pytest.approx(1.5)
    assert readers.device_ms_per_unit(Run, readers.INT8_KERNELS) is None
    out = trace.breakdown(Run.summary)
    assert out["device_ops"][0][0] == "batch norm"
    assert len(out["idle_gaps"]) <= 10
    assert any("below 0.95" in n for n in trace.notes(Run.summary))
