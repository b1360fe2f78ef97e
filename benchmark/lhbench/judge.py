"""The numbers that decide ``correct``, each beside its limit.

Training cells compare norms leaf by leaf: the gap between the program's
norm of a leaf and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger (some gradients are all
but zero), and the worst leaf is the number. Leaves whose gradient is
nought to rounding in the reference (under a thousandth of the median
leaf's) are left out of the parameters' change: Adam moves them by
round-off alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NOUGHT = 1e-3  # of the median leaf's gradient norm


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """Each leaf's gap between two vectors of per-leaf norms, 0 where a
    leaf is left out."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    gap = (prog - ref).abs() / torch.clamp_min(ref, float(ref.median()))
    if keep is not None:
        gap = torch.where(keep.cpu(), gap, torch.zeros_like(gap))
    return gap


def worst_leaf(gap: torch.Tensor) -> Tuple[float, int]:
    """(the worst leaf's gap, its index)."""
    i = int(torch.argmax(gap))
    return float(gap[i]), i


def median_leaf(gap: torch.Tensor, keep: torch.Tensor | None = None
                ) -> float:
    """The median over the kept leaves' gaps: steady from seed to seed
    where the worst leaf is a small early leaf's round-off."""
    return float((gap if keep is None else gap[keep.cpu()]).median())


def kept_leaves(ref_grad: torch.Tensor) -> torch.Tensor:
    """The leaves whose reference gradient norm is not nought to
    rounding."""
    return ref_grad >= NOUGHT * ref_grad.median()


def relative(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


class Checks:
    """Named numbers, each with its limit; a NaN number fails. A number
    the cell sets no limit for is kept in ``readings`` only (what the
    limits were chosen from)."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}
        self.readings: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        self.readings[name] = float(value)
        if name in self.limits:
            self.values[name] = float(value)

    def passed(self, name: str) -> bool:
        v = self.values[name]
        return not math.isnan(v) and v <= self.limits[name]

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits)
                and all(self.passed(n) for n in self.values))

    def line(self) -> dict:
        return {n: {"value": v, "limit": self.limits.get(n)}
                for n, v in self.values.items()}

    def lines(self) -> List[str]:
        return [f"check {n}: {v!r} (limit {self.limits.get(n)!r}) "
                + ("ok" if self.passed(n) else "FAILED")
                for n, v in self.values.items()]
