"""The benchmark's frozen yardstick: the card's published peaks, the least
time of a piece of work (on the f32 units, or on the tensor cores in
bf16), the bytes and operations of the program's two target kernels and
of attention, and the FLOPs of a configuration's forward.

The peaks and the K1/K2 counts are copied from ``chip_smoke.py``
(``PEAKS``, ``bound_ms``, ``K1_OPS_PER_PIXEL``, ``TARGET_OPS_PER_ELEMENT``
and phase 8's byte counts), so a later change to the program cannot move
them. The FLOPs come from the reference's layer shapes
(``reference.models.forward_flops``) and are frozen in each configuration
file as ``forward_flops``; a test holds the two equal.
"""

from __future__ import annotations

# Published peaks (NVIDIA data sheets, dense), keyed by a substring of the
# card's name: memory bytes/s, f32 (non-tensor-core) operations/s, int8
# tensor-core operations/s, f64 operations/s, bf16 tensor-core FLOP/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 1513e12, 26e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 1671e12, 30e12, 835e12),
    "H100": (3.35e12, 67e12, 1979e12, 34e12, 989e12),  # SXM
}
# the peak that every mfu divides by, whatever the policy, so that a change
# of precision shows as a change of mfu
MFU_PEAK_FLOPS = PEAKS["H100"][4]  # H100 SXM, bf16 dense

# f32 operations per pixel of K1's function: u8/255 (3), brightness (9),
# contrast incl. its gray mean (21), saturation (20), hue (~42), the
# enable gate (9), channel noise (9), normalize (6).
K1_OPS_PER_PIXEL = 119
TARGET_OPS_PER_ELEMENT = 10  # 2 sub, 2 abs+cmp, 2 mul, add, mul, exp
PARAMS_PER_IMAGE = 12  # K1's packed draws, f32


def peaks(kind: str) -> tuple:
    """The peak row of the card named ``kind`` (H100 SXM's where none
    matches)."""
    for key, val in PEAKS.items():
        if key in kind:
            return val
    return PEAKS["H100"]


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least time for the work on the card: bytes over the memory rate
    or f32 operations over the f32 rate, whichever is larger."""
    bw, flops = peaks(kind)[:2]
    return max(nbytes / bw, ops / flops)


def tensor_bound_s(nbytes: float, flops: float, kind: str) -> float:
    """The least time for bf16 tensor-core work on the card: bytes over
    the memory rate or FLOPs over the bf16 dense rate, whichever is
    larger."""
    row = peaks(kind)
    return max(nbytes / row[0], flops / row[4])


def attention_work(batch: int, heads: int, tokens: int, head_dim: int,
                   backward: bool) -> tuple:
    """(bytes, FLOPs) of one fused attention over ``tokens`` positions,
    bf16 operands, each read or written once. Forward: S = Q K^T and
    O = P V, 4 B H L^2 dh FLOPs; Q, K, V read, O written. Backward: S
    recomputed, then dV, dP, dQ and dK, 10 B H L^2 dh FLOPs; Q, K, V, O
    and dO read, dQ, dK and dV written, and the forward's f32 log-sum-exp
    (one a row) read."""
    elements = batch * heads * tokens * head_dim
    flops = (10 if backward else 4) * elements * tokens
    if not backward:
        return 4 * elements * 2, flops
    return 8 * elements * 2 + batch * heads * tokens * 4, flops


def k1_work(batch: int, size: int, joints: int, heatmap: int,
            out_bytes: int = 2) -> tuple:
    """(bytes, operations) of one K1 launch: each input read once (u8
    images, packed draws, f32 joints), each output written once (the
    normalised images in bf16, the f32 targets)."""
    n_px = batch * size * size
    n_hm = batch * joints * heatmap * heatmap
    nbytes = (n_px * 3 + batch * PARAMS_PER_IMAGE * 4 + batch * joints * 2 * 4
              + n_px * 3 * out_bytes + n_hm * 4)
    return nbytes, n_px * K1_OPS_PER_PIXEL + n_hm * TARGET_OPS_PER_ELEMENT


def k2_work(batch: int, joints: int, heatmap: int) -> tuple:
    """(bytes, operations) of one K2 launch: f32 joints in, f32 targets
    out."""
    n_hm = batch * joints * heatmap * heatmap
    return batch * joints * 2 * 4 + n_hm * 4, n_hm * TARGET_OPS_PER_ELEMENT


def train_flops(forward_flops: int) -> int:
    """A training step's FLOPs an image: forward, and a backward of twice
    the forward (no recompute)."""
    return 3 * forward_flops
