"""The frozen yardstick: each configuration's FLOPs and parameters from
the reference's shapes, the reference's names against the program's, and
the K1/K2 work and peaks copied from the chip smoke test."""

from __future__ import annotations

import pytest
import torch

from lhbench import spec, yardstick
from reference import models

CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]
# GFLOP a forward an image as counted with hooks on the program's model
PUBLISHED = {"hrnet_w32_256": 20.39, "simplebaseline_r50_256": 14.48}


def _config(name):
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return spec.read_json(spec.ROOT / entry["file"])


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_frozen_from_the_reference(name):
    cfg = _config(name)
    with torch.device("meta"):
        model = models.build(cfg)
    flops = 2 * models.forward_macs(model, cfg["image_size"])
    assert flops == cfg["forward_flops"]
    assert round(flops / 1e9, 2) == PUBLISHED[name]
    assert sum(p.numel() for p in model.parameters()) == cfg["parameters"]
    assert yardstick.train_flops(flops) == 3 * flops


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
