"""The CUDA kernels' launch geometry and wrappers, on the CPU.

The kernels themselves run only on the card (``chip_smoke.py`` holds them
against their plain twins there). What surrounds them is Python and is
checked here: K1's launch geometry covers every pixel of an image once
within the card's limits and mirrors the constants of
``csrc/fused_aug.cu``, and on CPU tensors both wrappers return their
twins' results bit for bit.
"""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from lighthand_tpu_torch.ops import heatmap
from lighthand_tpu_torch.ops.kernels import _build
from lighthand_tpu_torch.ops.kernels import fused_aug as k1
from lighthand_tpu_torch.ops.kernels.heatmap import generate_target_batch_cuda

T = torch.from_numpy


@pytest.mark.parametrize("hw", [(256, 256), (97, 131), (16, 16), (384, 384),
                                (517, 771), (1024, 1024)])
def test_launch_geometry_covers_each_pixel_once(hw):
    h, w = hw
    geo = k1.launch_geometry(h, w)
    assert 1 <= geo.cluster <= k1.MAX_CLUSTER
    assert geo.cluster & (geo.cluster - 1) == 0  # a power of two
    assert 32 <= geo.threads <= k1.MAX_THREADS and geo.threads % 32 == 0
    # thread t of block r holds pixels 8 (r * threads + t + g * cluster *
    # threads) + i, i < 8, for each of its groups g
    rank, tid, g, i = np.meshgrid(
        np.arange(geo.cluster), np.arange(geo.threads), np.arange(geo.groups),
        np.arange(k1.PX_PER_THREAD), indexing="ij")
    group = rank * geo.threads + tid + g * geo.cluster * geo.threads
    px = (group * k1.PX_PER_THREAD + i).ravel()
    held = np.bincount(px[px < h * w], minlength=h * w)
    assert (held == 1).all()
    # no block is wholly idle, and half the blocks could not hold the image
    # at two blocks to an SM
    assert (geo.cluster - 1) * geo.threads * k1.PX_PER_THREAD < h * w
    if geo.cluster > 1:
        assert (geo.cluster // 2) * k1.SHARED_SM_THREADS \
            * k1.PX_PER_THREAD < h * w
    # a thread walks groups only where the register kernel cannot hold the
    # image, and then as few as cover it
    capacity = k1.MAX_CLUSTER * k1.MAX_THREADS * k1.PX_PER_THREAD
    assert (geo.groups > 1) == (h * w > capacity)
    assert geo.cluster * geo.threads * (geo.groups - 1) * 8 < h * w


def test_launch_geometry_limits():
    assert k1.launch_geometry(256, 256) == k1.Geometry(16, 512)
    assert k1.launch_geometry(97, 131) == k1.Geometry(4, 416)
    big = k1.launch_geometry(300, 300)  # 16 blocks of more than 512
    assert big == k1.Geometry(16, 704)
    assert big.cluster * big.threads * k1.PX_PER_THREAD >= 300 * 300
    # above 16 x 1024 x 8 pixels, where the cap used to raise, threads walk
    assert k1.launch_geometry(384, 384) == k1.Geometry(16, 576, 2)
    assert k1.launch_geometry(512, 512) == k1.Geometry(16, 1024, 2)
    assert k1.launch_geometry(1024, 1024) == k1.Geometry(16, 1024, 8)
    with pytest.raises(ValueError):
        k1.launch_geometry(65536, 32768)  # 2^31 pixels


def test_geometry_constants_mirror_the_kernel():
    src = (_build.CSRC / "fused_aug.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kPx") == k1.PX_PER_THREAD
    assert const("kMaxThreads") == k1.MAX_THREADS
    assert const("kMaxCluster") == k1.MAX_CLUSTER
    assert "__launch_bounds__(kMaxThreads" in src
    # clusters above 8 blocks are launched with the non-portable attribute
    assert "if (cluster > 8)" in src
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in src
    # no dynamic shared memory; the static arrays (a 256-entry table, 32
    # warp sums, 4 partials, the draws, 32 map centres: under 2 KB) are far
    # below the 232,448 bytes a block may use
    assert "extern __shared__" not in src
    assert "cfg.dynamicSmemBytes = 0;" in src
    # the walking instance for images above the register kernel's capacity
    assert "fused_aug_groups_kernel(" in src
    assert "(long long)cluster * threads * kPx * groups < hw" in src


def _round32(x: Fraction) -> np.float32:
    """x rounded once to the nearest f32, ties to even."""
    f = np.float32(float(x))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - x),
                                    int(np.float32(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("c", [0, 1, 2])
def test_normalize_division_by_reciprocal_is_exact(c):
    """fused_aug.cu:div_std, a / std as q = a * (1 / std) and one FMA
    correction, gives the bits of the division on normalize's numerators
    (x - mean, x in [0, 1]); here on a sample with exact FMAs, on the card
    for every x (chip_smoke.py)."""
    mean, std = np.float32([0.485, 0.456, 0.406][c]), \
        np.float32([0.229, 0.224, 0.225][c])
    rcp = np.float32(1) / std
    rng = np.random.default_rng(c)
    xs = np.concatenate([
        rng.uniform(0, 1, 1500).astype(np.float32),
        (rng.integers(0, 256, 200) / np.float32(255)).astype(np.float32),
        np.float32([0, 1, mean, np.nextafter(mean, np.float32(0)),
                    np.nextafter(mean, np.float32(1))])])
    for x in xs:
        a = np.float32(x - mean)
        q = np.float32(a * rcp)
        e = _round32(Fraction(float(a)) - Fraction(float(q)) * Fraction(
            float(std)))
        got = _round32(Fraction(float(q)) + Fraction(float(e)) * Fraction(
            float(rcp)))
        assert got == a / std, (x, got, a / std)
    assert "kRcpStd[3] = {1.0f / 0.229f" in (
        _build.CSRC / "fused_aug.cu").read_text()


def test_build_sources_name_every_cu_file():
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}


def _k1_inputs(seed, b, h, w, cols):
    rng = np.random.default_rng(seed)
    images = T(rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8))
    joints = T(rng.uniform(-10, max(h, w) + 10, size=(b, 21, cols))
               .astype(np.float32))
    order = torch.tensor([[3, 1, 0, 2], [-1, 5, 1, 1], [1, 2, 3, 0]])[:b]
    params = k1.draw_aug_params(torch.Generator().manual_seed(seed),
                                torch.ones(b), torch.ones(b))
    params[:, 5:9] = order.float()
    return images, joints, params


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hw,cols", [((16, 16), 3), ((13, 11), 2)])
def test_fused_aug_wrapper_on_cpu_equals_twin(hw, cols, out_dtype):
    images, joints, params = _k1_inputs(7, 3, *hw, cols)
    before = k1.fused_aug_targets_cuda.launches
    got = k1.fused_aug_targets_cuda(images, joints, params, heatmap_size=8,
                                    stride=3.0, out_dtype=out_dtype)
    want = k1.fused_aug_targets_plain(images, joints, params, heatmap_size=8,
                                      stride=3.0, out_dtype=out_dtype)
    assert got[0].dtype == out_dtype and got[0].shape == images.shape
    assert got[1].shape == (3, 21, 8, 8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert k1.fused_aug_targets_cuda.launches == before


@pytest.mark.parametrize("hm,stride", [(64, 4.0), (50, 3.0)])
def test_heatmap_wrapper_on_cpu_equals_twin_with_three_columns(hm, stride):
    joints = T(np.random.default_rng(hm).uniform(
        -40, 300, size=(4, 21, 3)).astype(np.float32))
    before = generate_target_batch_cuda.launches
    got = generate_target_batch_cuda(joints, hm, stride, 2.0)
    torch.testing.assert_close(
        got, heatmap.generate_target_batch(joints[..., :2], hm, stride, 2.0),
        rtol=0, atol=0)
    assert got.shape == (4, 21, hm, hm)
    assert generate_target_batch_cuda.launches == before


def test_heatmap_wrapper_rejects_other_devices():
    with pytest.raises(ValueError):
        generate_target_batch_cuda(torch.zeros((2, 21, 2), device="meta"))
