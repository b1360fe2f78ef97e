"""Shared set-up of the benchmark's tests: the harness and the checkout on
``sys.path``, the ``card`` marker, and tiny cells for the CPU.

Tests marked ``card`` need an NVIDIA GPU; the ``card`` fixture skips them
elsewhere, deciding when the test runs, never at import. Run them on the
card with ``python3 -m pytest benchmark/tests -m card``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH.parent), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)

from lhbench import spec  # noqa: E402

TINY_CONFIGS = {
    "hrnet": {"model": "hrnet_tiny", "architecture": "hrnet",
              "widths": [8, 16, 32, 64], "stage_modules": [1, 1, 1],
              "blocks_per_branch": 1, "block": "BASIC", "fuse_method": "SUM",
              "stem_width": 64, "layer1_blocks": 4, "final_conv_kernel": 1,
              "num_joints": 21, "image_size": 64, "heatmap_size": 16,
              "sigma": 2.0, "forward_flops": 1},
    "simplebaseline": {"model": "resnet18", "architecture": "simplebaseline",
                       "num_layers": 18, "deconv_filters": [256, 256, 256],
                       "deconv_kernel": 4, "final_conv_kernel": 1,
                       "num_joints": 21, "image_size": 64,
                       "heatmap_size": 16, "sigma": 2.0,
                       "forward_flops": 1},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def tiny_cell(name: str, precision: str | None = None, batch: int = 4):
    """The cell ``name`` of ``BENCHMARK.json`` (its mix and limits) on its
    architecture's tiny configuration, at ``batch`` and 2 microbatches a
    dispatch, optionally under another ``precision``."""
    cell = spec.cell(spec.load_benchmark(), name)
    mix = dict(cell.mix, batch=batch, calibration_images=batch,
               trace_dispatches=1, trace_batches=2)
    if "scan_steps" in mix:
        mix["scan_steps"] = 2
    if precision is not None:
        mix["precision"] = precision
    cell.config = dict(TINY_CONFIGS[cell.config["architecture"]])
    cell.mix = mix
    return cell
