"""The reading of a profiled window: device busy time and idle gaps,
kernel families, host ranges, answered launches, from synthetic events
(the card's events exist only on the card)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

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


# kernels of attention and of LayerNorm as the profiler names them: torch's
# flash attention (cutlass templates), its memory-efficient kernels, cuDNN's
# SDPA, and LayerNorm's forward and backward
NEW_FAMILIES = [
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 64, "
     "64, 4, false, false, cutlass::bfloat16_t, Flash_kernel_traits<128, 64,"
     " 64, 4, cutlass::bfloat16_t> >, false, false, false, false, true, "
     "true, false, false>(pytorch_flash::Flash_fwd_params)", "attention"),
    ("void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<"
     "Flash_bwd_kernel_traits<128, 64, 128, 8, 2, 4, 2, false, false, "
     "cutlass::bfloat16_t, Flash_kernel_traits<128, 64, 128, 8, "
     "cutlass::bfloat16_t> >, false, false, false, false, false, true, "
     "false, false>(pytorch_flash::Flash_bwd_params)", "attention"),
    ("void pytorch_flash::flash_bwd_dot_do_o_kernel<true, "
     "Flash_bwd_kernel_traits<128, 64, 128, 8, 2, 4, 2, false, false, "
     "cutlass::bfloat16_t> >(pytorch_flash::Flash_bwd_params)", "attention"),
    ("void pytorch_flash::flash_bwd_convert_dq_kernel<Flash_bwd_kernel_traits"
     "<128, 64, 128, 8, 2, 4, 2, false, false, cutlass::bfloat16_t> >("
     "pytorch_flash::Flash_bwd_params, int)", "attention"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
     "AttentionKernel<cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, "
     "64, 64, true, true>::Params)", "attention"),
    ("fmha_cutlassB_bf16_aligned_64x64_k96_sm80(PyTorchMemEffAttention::"
     "AttentionBackwardKernel<cutlass::arch::Sm80, cutlass::bfloat16_t, "
     "true, false, true, 64, 64, 96, false>::Params)", "attention"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3_"
     "64x64x128_4x1x1_kernel0_0", "attention"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_bprop_wgmma_f16_knob_3_"
     "64x64x128_4x1x1_kernel0_0", "attention"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<"
     "c10::BFloat16, float>(int, float, c10::BFloat16 const*, c10::BFloat16 "
     "const*, c10::BFloat16 const*, float*, float*, c10::BFloat16*)",
     "layer norm"),
    ("void at::native::(anonymous namespace)::LayerNormForwardCUDAKernel<"
     "float, float>(long, float const*, float const*, float const*, float "
     "const*, float const*, float*)", "layer norm"),
    ("void at::native::(anonymous namespace)::"
     "layer_norm_grad_input_kernel_vectorized<c10::BFloat16, float>("
     "c10::BFloat16 const*, c10::BFloat16 const*, float const*, float "
     "const*, c10::BFloat16 const*, c10::BFloat16*, int)", "layer norm"),
    ("void at::native::(anonymous namespace)::"
     "GammaBetaBackwardCUDAKernelTemplate<c10::BFloat16, float, 32u, 32u, "
     "32u, false>(long, long, c10::BFloat16 const*, c10::BFloat16 const*, "
     "float const*, float const*, c10::BFloat16*, c10::BFloat16*)",
     "layer norm"),
]


@pytest.mark.parametrize("name,family", NEW_FAMILIES,
                         ids=[f"{f}-{i}" for i, (_, f) in
                              enumerate(NEW_FAMILIES)])
def test_attention_and_layer_norm_families(name, family):
    assert trace.family(trace.collapse(name)) == family


def test_todays_kernels_keep_their_families():
    """Every kernel the five cells launched on the card keeps the family
    it had before "attention" and "layer norm" were added, and none falls
    in either (``kernel_families.json``)."""
    path = Path(__file__).with_name("kernel_families.json")
    families = json.loads(path.read_text())["families"]
    assert len(families) > 200
    moved = {n: (f, trace.family(n)) for n, f in families.items()
             if trace.family(n) != f}
    assert moved == {}
    assert not {"attention", "layer norm"} & set(families.values())
    for pattern in ("lh_bn_", "dgrad", "wgrad", "multi_tensor_apply_kernel",
                    "fused_aug", "heatmap_targets", "int8_conv",
                    "quantize_weights", "elementwise_kernel", "copy"):
        assert any(pattern in n for n in families), pattern
