"""The frozen yardstick: each configuration's FLOPs and parameters from
the reference's shapes, counted again on the program's model, the
reference's names against the program's, the K1/K2 work and peaks
copied from the chip smoke test, and attention's work and the
tensor-core bound.

Every check of a configuration reads only its file, so a configuration
added as files alone is checked as the others are."""

from __future__ import annotations

import pytest
import torch
from torch import nn

from lhbench import spec, yardstick
from reference import models

CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]


def _config(name):
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return spec.read_json(spec.ROOT / entry["file"])


def program_model(cfg: dict) -> nn.Module:
    """The program's model of ``cfg`` in f32 on the CPU, every parameter
    and buffer 0: its BatchNorms take no meta tensor, and zeros keep one
    image's forward quick."""
    from lighthand_tpu_torch.core.dtypes import DTypePolicy
    from lighthand_tpu_torch.models import get_model

    with torch.device("meta"):
        model = get_model(cfg["model"], cfg["num_joints"],
                          policy=DTypePolicy.full_precision())
    model.to_empty(device="cpu")
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            t.zero_()
    return model.eval()


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_frozen_from_the_reference(name):
    cfg = _config(name)
    with torch.device("meta"):
        model = models.build(cfg)
    flops = models.forward_flops(model, cfg["image_size"])
    assert flops == cfg["forward_flops"]
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert yardstick.train_flops(flops) == 3 * flops


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_counted_on_the_program(name):
    """The same count on the program's own model, exact: the frozen
    FLOPs are those of what the cell times (one image's forward on the
    CPU; attention, where a model has it, on SDPA's math path)."""
    cfg = _config(name)
    model = program_model(cfg)
    assert models.forward_flops(model, cfg["image_size"]) == \
        cfg["forward_flops"]
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_names_match_the_program(name):
    from lighthand_tpu_torch.models import get_model

    cfg = _config(name)
    with torch.device("meta"):
        ref = models.build(cfg).state_dict()
        prog = get_model(cfg["model"], cfg["num_joints"]).state_dict()
    assert list(ref) == list(prog)
    assert all(ref[k].shape == prog[k].shape for k in ref)


def test_kernel_work_and_bounds():
    nbytes, ops = yardstick.k1_work(128, 256, 21, 64)
    assert round(nbytes / 1e6, 1) == 119.6
    assert yardstick.bound_s(nbytes, ops, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(nbytes / 3.35e12)
    nbytes, ops = yardstick.k2_work(128, 21, 64)
    assert round(nbytes / 1e6, 1) == 44.1
    assert yardstick.peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    assert yardstick.MFU_PEAK_FLOPS == 989e12


def test_attention_work_and_the_tensor_core_bound():
    """ViTPose-H's attention at bs64: 16 heads of 80 over 256 tokens."""
    h100 = "NVIDIA H100 80GB HBM3"
    nbytes, flops = yardstick.attention_work(64, 16, 256, 80, backward=False)
    assert (nbytes, flops) == (167_772_160, 21_474_836_480)
    assert yardstick.tensor_bound_s(nbytes, flops, h100) == \
        pytest.approx(nbytes / 3.35e12)  # bytes bind: ~50 us
    assert yardstick.tensor_bound_s(nbytes, flops, h100) == \
        pytest.approx(50.08e-6, rel=1e-3)
    nbytes, flops = yardstick.attention_work(64, 16, 256, 80, backward=True)
    lse = 64 * 16 * 256 * 4
    assert (nbytes - lse, flops) == (335_544_320, 53_687_091_200)
    assert yardstick.tensor_bound_s(nbytes, flops, h100) == \
        pytest.approx(nbytes / 3.35e12)
    # a product of large matrices binds on the tensor cores instead
    assert yardstick.tensor_bound_s(1e6, 989e12, h100) == pytest.approx(1.0)
    assert yardstick.tensor_bound_s(1e6, 756e12, "NVIDIA H100 PCIe") == \
        pytest.approx(1.0)
    assert yardstick.peaks("NVIDIA H100 NVL")[4] == 835e12
    assert yardstick.MFU_PEAK_FLOPS == yardstick.peaks(h100)[4]
