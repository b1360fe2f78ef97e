"""The frozen yardstick: each configuration's FLOPs and parameters from
the reference's shapes, counted again on the program's model, the
reference's names against the program's, and the K1/K2 work and peaks
copied from the chip smoke test.

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


def program_macs(model: nn.Module, image_size: int) -> int:
    """``models.forward_macs``'s count on the program's model: each conv's
    and deconv's multiply-accumulates from its shapes, by hooks on one
    image's forward on the CPU."""
    total = [0]

    def hook(m, inp, out):
        if isinstance(m, nn.ConvTranspose2d):
            x = inp[0]
            total[0] += (x.shape[1] * x.shape[2] * x.shape[3]
                         * m.out_channels * m.kernel_size[0]
                         * m.kernel_size[1])
        else:
            total[0] += (out.shape[1] * out.shape[2] * out.shape[3]
                         * m.in_channels // m.groups * m.kernel_size[0]
                         * m.kernel_size[1])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, image_size, image_size))
    finally:
        for h in handles:
            h.remove()
    return total[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_frozen_from_the_reference(name):
    cfg = _config(name)
    with torch.device("meta"):
        model = models.build(cfg)
    flops = 2 * models.forward_macs(model, cfg["image_size"])
    assert flops == cfg["forward_flops"]
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert yardstick.train_flops(flops) == 3 * flops


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_counted_on_the_program(name):
    """The same count on the program's own model, exact: the frozen
    FLOPs are those of what the cell times."""
    cfg = _config(name)
    model = program_model(cfg)
    assert 2 * program_macs(model, cfg["image_size"]) == cfg["forward_flops"]
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
