"""Shared set-up of the benchmark's tests: the harness and the checkout on
``sys.path``, the ``card`` marker, and tiny cells for the CPU, each on its
architecture's tiny configuration, ``tiny/<architecture>.json``.

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
    cell.config = spec.read_json(spec.BENCH_DIR / "tests" / "tiny" / (
        cell.config["architecture"] + ".json"))
    cell.mix = mix
    return cell
