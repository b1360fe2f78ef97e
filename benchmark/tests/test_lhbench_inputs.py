"""The seeded weights: today's configurations draw exactly what they drew
before linear layers and free parameters had rules, and each rule draws
what it says."""

from __future__ import annotations

import hashlib
import math

import pytest
import torch
from torch import nn

from lhbench import inputs, spec
from reference import models

CPU = torch.device("cpu")
SEED = 2**31 + 21
# sha256 over each entry's name, dtype and bytes in state-dict order, of
# ``inputs.weights`` on the CPU at SEED, taken before the rules for linear
# layers and free parameters existed; the counts are the entries of rank
# 4, 1 and 0
PINNED = {
    "hrnet_w32_256": ("72a4e9f4132cffd7b749558948200a7e"
                      "f4d06a9f788b968b0a53e2e7138edd8f", (293, 1169, 292)),
    "simplebaseline_r50_256": ("e2efd9cb5f2fe8398d5232151236c52d"
                               "d96887741ebf87f570bdc5801bd8c6f4",
                               (57, 225, 56)),
    "hrnet_w48_256": ("2658a025d93b04305557744c349863ab"
                      "69aa626ab6a3326bb54267ee0ec3433a", (293, 1169, 292)),
}


def digest(values) -> str:
    h = hashlib.sha256()
    for name, t in values.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_of_todays_configurations_are_pinned(name):
    bench = spec.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with torch.device("meta"):
        model = models.build(spec.read_json(spec.ROOT / entry["file"]))
    values = inputs.weights(model, SEED, CPU)
    ranks = tuple(sum(t.ndim == r for t in values.values())
                  for r in (4, 1, 0))
    assert (digest(values), ranks) == PINNED[name]


class Free(nn.Module):
    """A linear layer, a LayerNorm, a conv and a position embedding."""
    FREE_STD = {"pos_embed": 0.02}

    def __init__(self):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, 64, 48))
        self.norm = nn.LayerNorm(48)
        self.fc = nn.Linear(48, 96)
        self.conv = nn.Conv2d(3, 48, 4, bias=False)


def test_each_rule_draws_what_it_says():
    with torch.device("meta"):
        model = Free()
    values = inputs.weights(model, SEED, CPU)
    for name, bound in (("fc.weight", 1 / math.sqrt(48)),
                        ("fc.bias", 1 / math.sqrt(48)),
                        ("conv.weight", 1 / math.sqrt(3 * 4 * 4)),
                        ("pos_embed", 0.02 * math.sqrt(3))):
        t = values[name]
        assert t.abs().max() <= bound
        assert t.abs().max() > 0.9 * bound  # spread over the whole range
    assert values["pos_embed"].std().item() == pytest.approx(0.02, rel=0.05)
    assert torch.equal(values["norm.weight"], torch.ones(48))
    assert torch.equal(values["norm.bias"], torch.zeros(48))


def test_an_entry_of_rank_two_without_a_rule_raises():
    with torch.device("meta"):
        model = Free()
    model.FREE_STD = {}
    with pytest.raises(ValueError, match="pos_embed"):
        inputs.weights(model, SEED, CPU)
    model.FREE_STD = {"pos_embed": 0.02, "cls_token": 0.02}
    with pytest.raises(ValueError, match="cls_token"):
        inputs.weights(model, SEED, CPU)
