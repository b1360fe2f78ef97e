"""The port's int8_fwd and all_bf16 policies against the JAX package's, on
the CPU, where the two int8 kernels' wrappers (the weight quantize and the
conv that quantizes its activations) compute their plain twins: the conv,
its straight-through backward and the policies' plumbing.

Measured here (and held as stated):

- ``int8_conv`` (quantize, the s8 conv, the dequantizing epilogue) equals
  ``lighthand_tpu.ops.quant.int8_conv`` bit for bit on every shape tested,
  in f32 and bf16: 0 differing values, with rounding ties, clipped values
  and an all-zero weight channel among the inputs. Held exactly. The
  comparison is with JAX run eagerly: under ``jax.jit`` XLA rewrites
  ``m / 127.0`` into ``m * f32(1/127)`` and reassociates ``s_x * s_w``, so
  a standalone jitted call differs (11,720 of 50,688 values at 512 -> 512,
  9x11, measured with jax 0.9.0); whole jitted models still agree
  (tests/test_torch_quant_models.py).
- ``quantize_weight`` divides on both devices (a Python-scalar divisor on a
  CUDA tensor is a reciprocal multiply, which differs from division for
  4.7 % of f32 values).
- The straight-through gradient equals the port's plain conv gradient
  exactly (held exactly). Against JAX's: f32 max |diff| 3.0e-7 (dx, of
  magnitude 2.3) and 9.5e-6 (dw, of magnitude 28), i.e. 3.4e-7 relative;
  bf16 equal. Held at 1e-5 relative to each gradient's largest value.

The models under these policies are held in tests/test_torch_quant_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lighthand_tpu.cli.eval import serving_policy as jax_serving_policy
from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.ops.quant import _quant_forward
from lighthand_tpu.ops.quant import int8_conv as jax_int8_conv
from lighthand_tpu_torch.cli.eval import serving_policy
from lighthand_tpu_torch.config import parse_args
from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
from lighthand_tpu_torch.models.layers import Conv2d
from lighthand_tpu_torch.ops.kernels import _build
from lighthand_tpu_torch.ops.kernels.int8_conv import (
    Q_BULK,
    Q_GLOBAL,
    Q_LOAD,
    PATHS,
    Q_MAX_STAGE,
    QCONV,
    int8_conv2d_cuda,
    int8_conv2d_plain,
    pool_views,
    quantize_activation,
    quantize_plan,
    quantize_weight,
    quantize_weight_cuda,
    quantize_weight_plain,
    quantize_weights_cuda,
    quantize_weights_plain,
)
from lighthand_tpu_torch.ops.quant import int8_conv
from lighthand_tpu_torch.train.loop import _policy

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (N, H, W, Cin, Cout, k, stride): the stems (7x7 s2 and 3x3 s2 at Cin 3),
# 3x3 s1, 1x1 s2, 3x3 s2 on an odd size, and a 3x3 512 -> 512 conv
SHAPES = [(2, 33, 35, 3, 16, 7, 2), (2, 32, 32, 3, 16, 3, 2),
          (2, 16, 16, 64, 64, 3, 1), (2, 16, 16, 256, 512, 1, 2),
          (2, 17, 15, 8, 24, 3, 2), (1, 9, 11, 512, 512, 3, 1)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    torch's default of one thread per core oversubscribes the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _conv_inputs(shape, seed=0):
    n, h, w, cin, cout, k, _ = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, h, w, cin)) * 3).astype(np.float32)
    wt = (rng.normal(size=(k, k, cin, cout)) * 0.05).astype(np.float32)
    return x, wt


def _jax_conv(x, wt, k, s, dt):
    p = k // 2
    pad = ((p, p), (p, p)) if k > 1 else "VALID"
    return jax_int8_conv(jnp.asarray(x).astype(dt), jnp.asarray(wt), (s, s),
                         pad, 8.0, dt)


def _torch_x(x, dt):
    return torch.from_numpy(x).to(dt).permute(0, 3, 1, 2)


def _torch_w(wt):
    return torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()


# ------------------------------------------------------------ the conv


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_int8_conv_matches_jax_bit_exact(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    x, wt = _conv_inputs(shape)
    k, s = shape[5], shape[6]
    want = np.asarray(_jax_conv(x, wt, k, s, jdt).astype(jnp.float32))
    got = int8_conv(_torch_x(x, tdt), _torch_w(wt), s, k // 2, 8.0, tdt)
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


def test_quantize_matches_the_jax_formulas():
    """Weights per output channel from the f32 master (floor 1e-8), the
    activations at the static clip; both clamped to +-127."""
    x, wt = _conv_inputs((2, 8, 8, 16, 8, 3, 1), seed=3)
    wt[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    w_q, s_w = quantize_weight(_torch_w(wt))
    s_w_j = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(wt)), axis=(0, 1, 2)),
                        1e-8) / 127.0
    w_q_j = jnp.clip(jnp.round(jnp.asarray(wt) / s_w_j), -127, 127)
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(s_w_j))
    np.testing.assert_array_equal(w_q.permute(1, 2, 3, 0).numpy(),
                                  np.asarray(w_q_j).astype(np.int8))
    x[0, 0, 0, :4] = [100.0, -100.0, 0.5 * 8 / 127, -8.0]
    x_q = quantize_activation(_torch_x(x, torch.float32), 8.0)
    x_q_j = jnp.clip(jnp.round(jnp.asarray(x) * (1.0 / (8.0 / 127.0))),
                     -127, 127)
    np.testing.assert_array_equal(x_q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(x_q_j).astype(np.int8))
    assert x_q.dtype == w_q.dtype == torch.int8
    assert int(x_q.abs().max()) == 127


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_int8_wrapper_on_cpu_is_the_plain_twin(out_dtype, in_dtype):
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(3, 5, 13, 9)) * 4).astype(
        np.float32)).to(in_dtype)
    w_q = torch.from_numpy(rng.integers(-127, 128, (7, 3, 3, 5),
                                        dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, 7).astype(np.float32))
    before = int8_conv2d_cuda.launches
    got = int8_conv2d_cuda(x, w_q, scale, 8.0, 2, 1, out_dtype)
    want = int8_conv2d_plain(x, w_q, scale, 8.0, 2, 1, out_dtype)
    assert int8_conv2d_cuda.launches == before  # no launch on the CPU
    assert got.shape == (3, 7, 7, 5) and got.dtype == out_dtype
    assert torch.equal(got, want)
    # the plain twin is exact: the quantize, the integer conv, the epilogue
    x_q = quantize_activation(x, 8.0)
    acc = F.conv2d(x_q.long().double(), w_q.permute(0, 3, 1, 2).double(),
                   None, 2, 1)
    assert torch.equal(acc, acc.round())
    assert torch.equal(want, (acc.float() * scale[:, None, None])
                       .to(out_dtype))


@pytest.mark.parametrize("what", ["x_dtype", "w_dtype", "cin", "scale_dtype",
                                  "scale_shape", "out_dtype", "stride",
                                  "window", "ndim", "device", "act_clip"])
def test_int8_wrapper_rejects_bad_input(what):
    x = torch.zeros((1, 4, 8, 8), dtype=torch.bfloat16)
    w_q = torch.zeros((6, 3, 3, 4), dtype=torch.int8)
    scale = torch.ones(6)
    kw = {"act_clip": 8.0, "stride": 1, "padding": 1,
          "out_dtype": torch.bfloat16}
    exc = ValueError
    if what == "x_dtype":  # the kernel quantizes float activations itself
        x, exc = x.to(torch.int8), TypeError
    elif what == "w_dtype":
        w_q, exc = w_q.float(), TypeError
    elif what == "cin":
        w_q = torch.zeros((6, 3, 3, 5), dtype=torch.int8)
    elif what == "scale_dtype":
        scale = scale.double()
    elif what == "scale_shape":
        scale = torch.ones(5)
    elif what == "out_dtype":
        kw["out_dtype"] = torch.float16
    elif what == "stride":
        kw["stride"] = 0
    elif what == "window":
        w_q = torch.zeros((6, 11, 11, 4), dtype=torch.int8)
        kw["padding"] = 0
    elif what == "ndim":
        x = x[0]
    elif what == "device":
        x = x.to("meta")
    elif what == "act_clip":
        kw["act_clip"] = 0.0
    with pytest.raises(exc):
        int8_conv2d_cuda(x, w_q, scale, **kw)


# The stem path's ragged shapes, (N, H, W, Cin, Cout, k, stride, pad): N=1
# on odd sizes, Cout 40 and 100 at Cin 3, Cin 8 at 3x3 (K = 72), pad 0 on
# the 7x7 stem and pad 3 on a 3x3, and a strided 1x1 at Cin 48 (K = 48)
STEM_SHAPES = [(1, 33, 47, 3, 64, 7, 2, 3), (2, 31, 29, 3, 40, 7, 2, 3),
               (2, 31, 29, 3, 100, 3, 2, 1), (1, 9, 11, 8, 24, 3, 2, 1),
               (2, 40, 40, 3, 64, 7, 2, 0), (2, 19, 21, 3, 64, 3, 1, 3),
               (2, 33, 17, 48, 33, 1, 2, 0)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", STEM_SHAPES,
                         ids=[str(s) for s in STEM_SHAPES])
def test_stem_shapes_through_the_wrapper_match_jax(shape, dtype):
    """The shapes that take the conv kernel's stem path on the card, through
    the CPU wrapper (the twin), against eager JAX's ``_quant_forward`` with
    the same padding: bit for bit, ties, clipped values and zeros in x."""
    jdt, tdt = DTYPES[dtype]
    x, wt = _conv_inputs(shape[:7], seed=13)
    special = _ties_and_clips(tdt)
    flat = x.reshape(-1)
    flat[:len(special)] = special[:len(flat)]
    k, s, pad = shape[5:]
    want = np.asarray(_quant_forward(
        jnp.asarray(x).astype(jdt), jnp.asarray(wt), (s, s),
        ((pad, pad), (pad, pad)), 8.0, jdt).astype(jnp.float32))
    w_q, _, scale = quantize_weight_cuda(_torch_w(wt), 8.0)
    got = int8_conv2d_cuda(_torch_x(x, tdt), w_q, scale, 8.0, s, pad, tdt)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0


# ------------------------------------------------------ the weight kernel


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_weight_wrapper_on_cpu_is_the_plain_twin(layout):
    """The wrapper computes the twin on the CPU, launches nothing, and
    gives ``scale`` = s_w * f32(act_clip / 127), as JAX's
    ``(s_x * s_w).astype(f32)`` with a weakly typed s_x."""
    _, wt = _conv_inputs((1, 4, 4, 12, 10, 3, 1), seed=8)
    w = _torch_w(wt)
    if layout == "channels_last":
        w = w.contiguous(memory_format=torch.channels_last)
    before = quantize_weights_cuda.launches
    w_q, s_w, scale = quantize_weight_cuda(w, 8.0)
    assert quantize_weights_cuda.launches == before
    want = quantize_weight_plain(_torch_w(wt), 8.0)
    for got, ref in zip((w_q, s_w, scale), want):
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    assert w_q.shape == (10, 3, 3, 12) and w_q.is_contiguous()
    s_w_j = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(wt)), axis=(0, 1, 2)),
                        1e-8) / 127.0
    scale_j = (8.0 / 127.0 * s_w_j).astype(jnp.float32)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_j))


def test_quantize_weight_divides():
    """s_w = m / 127 is a true division on the CPU too (and on the card,
    where a Python-scalar divisor would be a reciprocal multiply): equal to
    numpy's f32 division on draws where m * f32(1/127) differs."""
    rng = np.random.default_rng(9)
    m = rng.uniform(1e-3, 2.0, 4096).astype(np.float32)
    m = m[m * np.float32(1 / 127) != m / np.float32(127)][:64]
    assert len(m) == 64
    w = np.zeros((64, 2, 1, 1), np.float32)
    w[:, 0, 0, 0] = m
    w[:, 1, 0, 0] = -m / 3
    _, s_w = quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(s_w.numpy(), m / np.float32(127))
    assert (s_w.numpy() != m * np.float32(1 / 127)).all()


@pytest.mark.parametrize("what", ["dtype", "ndim", "device", "act_clip"])
def test_weight_wrapper_rejects_bad_input(what):
    w, act_clip = torch.ones((4, 3, 3, 3)), 8.0
    if what == "dtype":
        w = w.to(torch.bfloat16)
    elif what == "ndim":
        w = w[0]
    elif what == "device":
        w = w.to("meta")
    elif what == "act_clip":
        act_clip = -1.0
    with pytest.raises(ValueError):
        quantize_weight_cuda(w, act_clip)


# ------------------------------------------- the grouped weight kernel

# [Cout, Cin, kh, kw] of a group: K = 27 (a 3x3 stem), 147 (the 7x7 stem),
# 288, 2304 and 4608 (ResNet-50's largest), Cout 40 and 33, a 1x1, and rows
# of 45 and 20 values (not multiples of 16 bytes, or of 16 values)
GROUP = [(64, 3, 3, 3), (64, 3, 7, 7), (32, 32, 3, 3), (40, 256, 3, 3),
         (33, 512, 3, 3), (48, 64, 1, 1), (7, 5, 3, 3), (9, 20, 1, 1)]


def _group(layout, seed=12):
    rng = np.random.default_rng(seed)
    ws = []
    for i, shape in enumerate(GROUP):
        w = torch.from_numpy((rng.normal(size=shape) * 0.05)
                             .astype(np.float32))
        w[i % shape[0]] = 0.0  # an all-zero channel: the 1e-8 floor
        if layout == "channels_last":
            w = w.contiguous(memory_format=torch.channels_last)
        ws.append(w)
    return ws


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_grouped_wrapper_on_cpu_is_the_plain_twin(layout):
    """On the CPU the grouped wrapper is ``quantize_weight_plain`` of each
    weight, bit for bit, and launches nothing."""
    ws = _group(layout)
    before = quantize_weights_cuda.launches
    got = quantize_weights_cuda(ws, 8.0)
    assert quantize_weights_cuda.launches == before
    assert len(got) == len(ws)
    for w, mine, plain in zip(ws, got, quantize_weights_plain(ws, 8.0)):
        want = quantize_weight_plain(w.contiguous(), 8.0)
        for a, b, c in zip(mine, plain, want):
            assert a.dtype == c.dtype and torch.equal(a, c)
            assert torch.equal(b, c)
        assert not mine[0][GROUP.index(tuple(w.shape)) % w.shape[0]].any()


def _run_table(plan, ws, act_clip):
    """What the kernel does with ``plan``'s table, item by item, in numpy:
    each item's channels read through the row's pointer and strides (into
    ``ws``, found by pointer), quantized as the twin does, written at the
    row's offsets. Returns the s8 and f32 pools."""
    head = plan["n_convs"] * QCONV.size
    rows = [QCONV.unpack_from(plan["table"], i * QCONV.size)
            for i in range(plan["n_convs"])]
    start = -(-head // 16) * 16
    items = np.frombuffer(plan["table"][start:], dtype="<i4").reshape(-1, 2)
    assert len(items) == plan["n_items"]
    by_ptr = {w.data_ptr(): w for w in ws}
    pool = np.full(plan["wq_bytes"], 99, np.int8)
    fpool = np.full(2 * plan["n_sw"], np.nan, np.float32)
    sx = np.float32(8.0 / 127.0) if act_clip == 8.0 else None
    seen = set()
    for conv, ch0 in items:
        ptr, s0, s1, s2, s3, wq, cout, cin, kh, kw, sw, cpi, mode, flat = \
            rows[conv]
        w = by_ptr[ptr]
        assert (s0, s1, s2, s3) == w.stride()
        k = cin * kh * kw
        for ch in range(ch0, min(ch0 + cpi, cout)):
            assert (conv, ch) not in seen
            seen.add((conv, ch))
            w_q, s_w, scale = quantize_weight_plain(w[ch:ch + 1], act_clip)
            pool[wq + ch * k:wq + (ch + 1) * k] = w_q.reshape(-1).numpy()
            fpool[sw + ch] = s_w.numpy()[0]
            fpool[plan["n_sw"] + sw + ch] = scale.numpy()[0]
            assert fpool[plan["n_sw"] + sw + ch] == s_w.numpy()[0] * sx
    assert seen == {(i, c) for i, r in enumerate(rows)
                    for c in range(r[6])}
    return torch.from_numpy(pool), torch.from_numpy(fpool)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_quantize_plan_views(layout):
    """The table covers every channel of every weight once, and the views
    of the pools at the plan's offsets are each weight's (w_q, s_w, scale):
    w_q ``[Cout, kh, kw, Cin]`` contiguous at a 128-byte offset."""
    ws = _group(layout)
    plan = quantize_plan([(w.data_ptr(), tuple(w.shape), w.stride())
                          for w in ws])
    pool, fpool = _run_table(plan, ws, 8.0)
    views = pool_views(plan, pool, fpool)
    for w, (w_q, s_w, scale) in zip(ws, views):
        cout, cin, kh, kw = w.shape
        assert w_q.shape == (cout, kh, kw, cin) and w_q.is_contiguous()
        assert (w_q.data_ptr() - pool.data_ptr()) % 128 == 0
        assert s_w.shape == scale.shape == (cout,)
        for a, b in zip((w_q, s_w, scale), quantize_weight_plain(w, 8.0)):
            assert torch.equal(a, b)
    assert 0 < plan["stage"] <= Q_MAX_STAGE and plan["stage"] % 16 == 0


def test_quantize_plan_modes():
    """How each weight's rows reach a block: TMA bulk copies for dense,
    16-byte aligned rows of a multiple of 16 bytes; the block's own loads
    for the rest of the dense adjacent rows (the stems, a source off 16
    bytes); in place for other strides and rows beyond a stage buffer."""
    def mode(shape, stride=None, ptr=1 << 20):
        if stride is None:
            stride = torch.empty(shape).stride()
        table = quantize_plan([(ptr, shape, stride)])["table"]
        return QCONV.unpack_from(table)[12]

    cl = torch.empty(32, 32, 3, 3).contiguous(
        memory_format=torch.channels_last).stride()
    assert mode((32, 32, 3, 3)) == Q_BULK
    assert mode((32, 32, 3, 3), cl) == Q_BULK
    assert mode((64, 3, 3, 3)) == Q_LOAD          # K = 27
    assert mode((64, 3, 7, 7)) == Q_LOAD          # K = 147
    assert mode((32, 32, 3, 3), ptr=(1 << 20) + 4) == Q_LOAD
    assert mode((8, 32, 3, 3), (576, 9, 3, 1)) == Q_BULK  # every other row
    assert mode((8, 32, 3, 3), (577, 9, 3, 1)) == Q_GLOBAL
    assert mode((32, 32, 3, 3), (288, 1, 3, 96)) == Q_GLOBAL  # not dense
    assert mode((4, 8192, 3, 3)) == Q_GLOBAL      # 288 KB rows
    plan = quantize_plan([(1 << 20, (256, 256, 3, 3), (2304, 9, 3, 1)),
                          (1 << 24, (64, 3, 3, 3), (27, 9, 3, 1))])
    assert [v[2] for v in plan["wq_views"]] == [0, 256 * 2304]
    assert plan["n_sw"] == 256 + 64 and plan["couts"] == [256, 64]


def test_pool_offsets_are_aligned():
    plan = quantize_plan([(0, (33, 3, 3, 3), (27, 9, 3, 1)),
                          (0, (5, 7, 1, 1), (7, 1, 1, 1)),
                          (0, (40, 64, 3, 3), (576, 9, 3, 1))])
    assert [v[2] for v in plan["wq_views"]] == [0, 896, 1024]
    assert [QCONV.unpack_from(plan["table"], i * QCONV.size)[10]
            for i in range(3)] == [0, 33, 38]
    assert plan["n_sw"] == 78 and plan["wq_bytes"] == 1024 + 40 * 576


@pytest.mark.parametrize("what", ["empty", "dtype", "ndim", "devices",
                                  "device", "act_clip", "no_input"])
def test_grouped_wrapper_rejects_bad_groups(what):
    ws, act_clip = [torch.ones((4, 3, 3, 3)), torch.ones((8, 4, 1, 1))], 8.0
    if what == "empty":
        ws = []
    elif what == "dtype":
        ws[1] = ws[1].double()
    elif what == "ndim":
        ws[1] = ws[1][0]
    elif what == "devices":
        ws[1] = ws[1].to("meta")
    elif what == "device":
        ws = [w.to("meta") for w in ws]
    elif what == "act_clip":
        act_clip = 0.0
    elif what == "no_input":
        ws[0] = torch.ones((4, 0, 3, 3))
    with pytest.raises(ValueError):
        quantize_weights_cuda(ws, act_clip)


# --------------------------------------- the fused quantize against JAX


def _ties_and_clips(dt):
    """Activations in ``dt`` on which f32(x * inv) is k + 0.5 (rounding
    ties), beyond +-act_clip, and exact zeros. In f32: the neighbours of
    (k + 0.5) / inv whose product rounds to the tie; in bf16, whose product
    with inv = 15.875 is exact, the only ties inside the clip are +-4."""
    inv = np.float32(1.0 / (8.0 / 127.0))
    if dt == torch.float32:
        near = np.float32((np.arange(-127, 127) + 0.5) / inv)
        cand = np.concatenate([near, np.nextafter(near, np.float32(np.inf)),
                               np.nextafter(near, np.float32(-np.inf))])
    else:
        cand = torch.linspace(-10, 10, 200001).to(dt).unique().float().numpy()
    prod = cand * inv
    ties = cand[(prod - np.floor(prod)) == 0.5]
    assert len(ties) >= (200 if dt == torch.float32 else 2)
    return np.concatenate([ties, [8.5, -8.5, 100.0, -100.0, 8.0, -8.0, 0.0,
                                  -0.0]]).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_fused_quantize_twin_matches_jax_bit_exact(shape, dtype):
    """The conv kernel's twin (quantize inside, from bf16 or f32 x) and the
    weight kernel's twin equal eager JAX ``int8_conv``, with the rounding
    ties, the clip and zeros in x and an all-zero output channel (the 1e-8
    floor) in w."""
    jdt, tdt = DTYPES[dtype]
    x, wt = _conv_inputs(shape, seed=11)
    special = _ties_and_clips(tdt)
    flat = x.reshape(-1)
    flat[:len(special)] = special[:len(flat)]
    wt[..., 1] = 0.0
    k, s = shape[5], shape[6]
    want = np.asarray(_jax_conv(x, wt, k, s, jdt).astype(jnp.float32))
    w_q, _, scale = quantize_weight_plain(_torch_w(wt), 8.0)
    got = int8_conv2d_plain(_torch_x(x, tdt), w_q, scale, 8.0, s, k // 2,
                            tdt)
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert int((got != want).sum()) == 0
    assert not got[..., 1].any()  # the zero channel's scale is the floor's


# ------------------------------------------------------ the STE backward


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_conv_ste_gradient_exact(dtype):
    """The backward is exactly the plain conv's (the port's Conv2d) vjp at
    (x, w): dx in x's dtype, dw in w's (f32), on an arbitrary cotangent."""
    _, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = _torch_x(rng.normal(size=(2, 12, 12, 8)).astype(np.float32), tdt)
    w = _torch_w((rng.normal(size=(3, 3, 8, 16)) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 16, 6, 6)).astype(np.float32))

    conv = Conv2d(8, 16, 3, stride=2, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(w)
    xp = x.clone().requires_grad_()
    conv(xp).backward(g.to(tdt))

    xq, wq = x.clone().requires_grad_(), w.clone().requires_grad_()
    int8_conv(xq, wq, 2, 1, 8.0, tdt).backward(g.to(tdt))
    assert xq.grad.dtype == tdt and wq.grad.dtype == torch.float32
    assert torch.equal(xq.grad, xp.grad)
    assert torch.equal(wq.grad, conv.weight.grad)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_conv_ste_gradient_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 12, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 16)) * 0.1).astype(np.float32)
    g = rng.normal(size=(2, 6, 6, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_int8_conv(a, b, (2, 2),
                                                ((1, 1), (1, 1)), 8.0, jdt),
                     jnp.asarray(x).astype(jdt), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g).astype(jdt))
    xt = _torch_x(x, tdt).requires_grad_()
    wt = _torch_w(w).requires_grad_()
    int8_conv(xt, wt, 2, 1, 8.0, tdt).backward(
        torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    for got, want in ((xt.grad.float().permute(0, 2, 3, 1).numpy(),
                       np.asarray(dxj.astype(jnp.float32))),
                      (wt.grad.permute(2, 3, 1, 0).numpy(),
                       np.asarray(dwj))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------- policies


def test_policy_constructors_match_jax():
    for ours, theirs in ((DTypePolicy(), JaxPolicy()),
                         (DTypePolicy.all_bf16(), JaxPolicy.all_bf16()),
                         (DTypePolicy.int8_fwd(), JaxPolicy.int8_fwd()),
                         (DTypePolicy.full_precision(),
                          JaxPolicy.full_precision())):
        assert ours.quant_fwd == theirs.quant_fwd
        assert ours.act_clip == theirs.act_clip
        for field in ("param_dtype", "compute_dtype", "output_dtype",
                      "bn_dtype"):
            assert (str(getattr(ours, field)).removeprefix("torch.")
                    == jnp.dtype(getattr(theirs, field)).name), field


@pytest.mark.parametrize("policy", ["full_precision", "default",
                                    "all_bf16", "int8_fwd"])
def test_numerics_turns_tf32_off_for_f32_only(policy, monkeypatch):
    """``numerics`` sets both TF32 switches False for an f32 policy and
    restores them on exit, an exception included; other policies leave
    them alone."""
    pol = (DTypePolicy() if policy == "default"
           else getattr(DTypePolicy, policy)())
    f32 = pol.compute_dtype == torch.float32

    def switches():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)

    for before in ((True, True), (True, False), (False, True)):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[0])
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            before[1])
        with numerics(pol):
            assert switches() == ((False, False) if f32 else before)
        assert switches() == before
        with pytest.raises(KeyError), numerics(pol):
            raise KeyError
        assert switches() == before


@pytest.mark.parametrize("precision", ["bf16", "f32", "all_bf16",
                                       "int8_fwd"])
def test_training_accepts_every_precision(precision):
    cfg = parse_args(["--precision", precision])
    want = {"bf16": DTypePolicy(), "f32": DTypePolicy.full_precision(),
            "all_bf16": DTypePolicy.all_bf16(),
            "int8_fwd": DTypePolicy.int8_fwd()}[precision]
    assert _policy(cfg) == want


_INFOS = {"f32": {"name": "simplebaseline", "precision": "f32"},
          "bf16": {"name": "simplebaseline", "precision": "bf16"},
          "none": None, "nameless": {"precision": "f32"}}


@pytest.mark.parametrize("info", sorted(_INFOS))
@pytest.mark.parametrize("precision", ["bf16", "f32", "all_bf16",
                                       "int8_fwd"])
def test_serving_policy_matches_jax(precision, info):
    """--precision int8_fwd forces the quantized forward on any checkpoint;
    otherwise the checkpoint's recorded precision wins, then the CLI's."""
    got = serving_policy(precision, _INFOS[info])
    want = jax_serving_policy(precision, _INFOS[info])
    assert got.quant_fwd == want.quant_fwd
    assert got.compute_dtype == {jnp.dtype(jnp.float32): torch.float32,
                                 jnp.dtype(jnp.bfloat16): torch.bfloat16}[
                                     jnp.dtype(want.compute_dtype)]
    if precision == "int8_fwd":
        assert got.quant_fwd
    if info == "f32" and precision != "int8_fwd":
        assert got.compute_dtype == torch.float32


def test_kernel_source_holds_the_jax_formulas():
    """The kernels run only on the card (chip_smoke.py holds them against
    the twins there); here their source is checked for the twins'
    operations: an IEEE division for s_w (no fast math), round-to-nearest-
    even and a clamp to +-127 on both operands, the f32 scale product and
    the epilogue's int32 -> f32 conversion."""
    src = (_build.CSRC / "int8_conv.cu").read_text()
    for formula in ("fmaxf(amax, 1e-8f)", "m / 127.0f",
                    "rintf(v / sw)", "-127.0f), 127.0f)", "sw * sx",
                    "__float2int_rn(__fmul_rn(x, inv))", "-127), 127)",
                    "__int2float_rn(acc"):
        assert formula in src, formula
    # every path's activations go through quantize(); both wgmma paths (the
    # main and the stem) end in the one epilogue, which holds the conversion
    def body(name):
        start = src.index(f"\n{name}(")
        return src[start:src.index("\n}\n", start)]

    for kernel in ("int8_conv_simple", "int8_conv_wgmma", "int8_conv_stem"):
        assert "quantize(" in body(kernel) or "quant8(" in body(kernel)
    for kernel in ("int8_conv_wgmma", "int8_conv_stem"):
        assert "stage_tile<OutT, BN>(acc" in body(kernel), kernel
    epilogue = body("__device__ __forceinline__ void stage_tile")
    assert "__int2float_rn(acc[4 * j + 2 * hf]) * s0" in epilogue
    assert "to_float(xn[" in body("int8_conv_stem")  # x as it is read
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "int8_conv" in _build.SOURCES


def test_conv_plan_paths_follow_the_kernel_enum():
    """``conv_plan`` names the path the kernel reports by its ``Path`` value:
    the tuple must list the enum's names in its order."""
    import re

    src = (_build.CSRC / "int8_conv.cu").read_text()
    enum = re.search(r"enum Path \{([^}]*)\}", src).group(1)
    names = [re.match(r"\s*k(\w+)Path = (\d+)", item).groups()
             for item in enum.split(",")]
    assert [int(v) for _, v in names] == list(range(len(names)))
    assert [n.lower() for n, _ in names] == list(PATHS)
