"""The port's BatchNorm(+ReLU) (``ops/kernels/batch_norm.py`` through
``models/layers.py:BatchNorm2d``) against Flax's ``nn.BatchNorm`` followed
by the cast and ``relu`` of the JAX package's ``ConvBN``, on the same numpy
inputs (CPU: the kernels' plain twins and their autograd Function).

Tolerances: f32 values atol 1e-5 (the two frameworks compute the same
formulas, but the statistics and the gradients' sums add in another order;
tests/test_torch_ops.py's f32 tolerance); bf16 values within 1 bf16 ulp of
the JAX value (the same f32 value can round to either neighbour; the
tests/test_torch_ops.py rule) plus that 1e-5 where terms cancel to near 0;
bf16 grad_input in training plus 1 bf16 ulp of its largest value instead:
JAX's gradient reaches the bf16 input by two paths (directly, and through
the batch statistics), each cast to bf16 before they are summed, one
rounding more than the port's f32 sum, at the size of the terms (measured
up to 1 ulp of the largest value); running statistics atol 1e-5, rtol 1e-4
(tests/test_torch_models.py).

Also here: the models fuse a ReLU into exactly the BatchNorms that the JAX
models follow with one; the end of a residual block (``bn(x,
residual=r)``) equals the chain BN, add, ReLU bit for bit, forward and
gradients, and its wrappers count it; every kernel of
``csrc/batch_norm.cu`` falls in the benchmark's "batch norm" family, which
``bn_ms.train`` reads; the grid plan of the kernels covers every BatchNorm
shape of the cells.
"""

import copy
import importlib.util
import re
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.models.layers import BN_EPS as JAX_EPS
from lighthand_tpu.models.layers import BN_MOMENTUM as JAX_MOMENTUM
from lighthand_tpu.models.layers import ConvBN as JaxConvBN
from lighthand_tpu.models.resnet import DeconvBNRelu as JaxDeconvBNRelu
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.layers import BatchNorm2d
from lighthand_tpu_torch.ops.kernels import _build
from lighthand_tpu_torch.ops.kernels import batch_norm as bn

ROOT = Path(__file__).resolve().parents[1]
F32_ATOL = 1e-5
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}


class _JaxBN(fnn.Module):
    """The BatchNorm of the JAX package's ``ConvBN`` (layers.py:111-121):
    Flax's BatchNorm in f32, the cast to the compute dtype, the ReLU."""

    relu: bool
    train: bool
    compute_dtype: object

    @fnn.compact
    def __call__(self, x):
        y = fnn.BatchNorm(use_running_average=not self.train,
                          momentum=JAX_MOMENTUM, epsilon=JAX_EPS,
                          dtype=jnp.float32, param_dtype=jnp.float32)(x)
        y = y.astype(self.compute_dtype)
        return fnn.relu(y) if self.relu else y


def _inputs(c, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"x": rng.normal(0.7, 2.0, size=(3, 5, 4, c)).astype(f),
            "dy": rng.normal(size=(3, 5, 4, c)).astype(f),
            "scale": rng.uniform(0.5, 1.5, size=c).astype(f),
            "bias": rng.normal(0, 0.3, size=c).astype(f),
            "mean": rng.normal(0, 0.1, size=c).astype(f),
            "var": rng.uniform(0.5, 1.5, size=c).astype(f)}


def _jax(d, train, relu, dtype):
    module = _JaxBN(relu=relu, train=train, compute_dtype=dtype)
    params = {"BatchNorm_0": {"scale": jnp.asarray(d["scale"]),
                              "bias": jnp.asarray(d["bias"])}}
    stats = {"BatchNorm_0": {"mean": jnp.asarray(d["mean"]),
                             "var": jnp.asarray(d["var"])}}

    def fwd(x, p):
        variables = {"params": p, "batch_stats": stats}
        if train:
            y, upd = module.apply(variables, x, mutable=["batch_stats"])
            return y, upd["batch_stats"]["BatchNorm_0"]
        return module.apply(variables, x), stats["BatchNorm_0"]

    x = jnp.asarray(d["x"]).astype(dtype)
    y, vjp, new_stats = jax.vjp(fwd, x, params, has_aux=True)
    dx, dp = vjp(jnp.asarray(d["dy"]).astype(dtype))
    nchw = (0, 3, 1, 2)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return {"y": f32(y).transpose(nchw), "dx": f32(dx).transpose(nchw),
            "dw": f32(dp["BatchNorm_0"]["scale"]),
            "db": f32(dp["BatchNorm_0"]["bias"]),
            "mean": f32(new_stats["mean"]), "var": f32(new_stats["var"])}


def _port(d, train, relu, dtype):
    c = d["x"].shape[-1]
    m = BatchNorm2d(c, relu=relu).train(train)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(m, name).copy_(torch.from_numpy(d[key]))
    x = torch.from_numpy(d["x"]).permute(0, 3, 1, 2).to(dtype)
    x = x.contiguous().requires_grad_()
    y = m(x)
    y.backward(torch.from_numpy(d["dy"]).permute(0, 3, 1, 2).to(dtype))
    f32 = lambda t: t.detach().float().numpy()  # noqa: E731
    return {"y": f32(y), "dx": f32(x.grad), "dw": f32(m.weight.grad),
            "db": f32(m.bias.grad), "mean": f32(m.running_mean),
            "var": f32(m.running_var), "dtypes": (y.dtype, x.grad.dtype),
            "batches": int(m.num_batches_tracked)}


def _bf16_ulp(x):
    """Spacing of bf16 at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("c", [4, 32])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_flax(train, relu, precision, c):
    """Forward, grad_input, grad_weight, grad_bias and the running
    statistics of ``BatchNorm2d(relu=...)`` equal Flax's BatchNorm, cast
    and ReLU; outputs and grad_input in the compute dtype."""
    torch_dtype, jax_dtype = DTYPES[precision]
    d = _inputs(c, seed=c + 2 * relu + 4 * train)
    want = _jax(d, train, relu, jax_dtype)
    got = _port(d, train, relu, torch_dtype)
    assert got["dtypes"] == (torch_dtype, torch_dtype)
    for key in ("y", "dx"):
        err = np.abs(got[key] - want[key])
        if precision == "bf16":
            floor = (_bf16_ulp(np.abs(want[key]).max())
                     if key == "dx" and train else F32_ATOL)
            assert (err <= _bf16_ulp(want[key]) + floor).all(), (
                key, err.max())
        else:
            np.testing.assert_allclose(got[key], want[key], atol=F32_ATOL,
                                       rtol=0, err_msg=key)
    for key in ("dw", "db"):
        np.testing.assert_allclose(got[key], want[key], atol=F32_ATOL,
                                   rtol=0, err_msg=key)
    for key in ("mean", "var"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)
    assert got["batches"] == int(train)


def _jax_bn_relu_pairs(name):
    """(BatchNorms, BatchNorms followed by a ReLU) of one forward of the
    JAX model: every BatchNorm of both JAX models sits in a ``ConvBN``
    (whose ReLU follows it where ``relu``) or a ``DeconvBNRelu`` (always)."""
    seen = {"bn": 0, "convbn": 0, "convbn_relu": 0, "deconv": 0}

    def record(next_fun, args, kwargs, context):
        if context.method_name == "__call__":
            m = context.module
            if isinstance(m, fnn.BatchNorm):
                seen["bn"] += 1
            elif isinstance(m, JaxConvBN):
                seen["convbn"] += 1
                seen["convbn_relu"] += bool(m.relu)
            elif isinstance(m, JaxDeconvBNRelu):
                seen["deconv"] += 1
        return next_fun(*args, **kwargs)

    model = jax_get_model(name)
    with fnn.intercept_methods(record):
        jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)),
                                            train=False),
                       jax.random.PRNGKey(0))
    assert seen["bn"] == seen["convbn"] + seen["deconv"]
    return seen["bn"], seen["convbn_relu"] + seen["deconv"]


@pytest.mark.parametrize("name,n_bn", [("hrnet_w32", 292),
                                       ("simplebaseline", 56)])
def test_fused_relus_are_the_jax_models_bn_relu_pairs(name, n_bn):
    """The port fuses a ReLU into as many BatchNorms as the JAX model
    follows with one, and its forwards call no separate ReLU there (the
    f32 forwards against JAX, tests/test_torch_models.py and
    test_torch_resnet.py, hold where)."""
    port = get_model(name)
    bns = [m for m in port.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == n_bn
    assert not any(isinstance(m, torch.nn.ReLU) for m in port.modules())
    assert (len(bns), sum(m.relu for m in bns)) == _jax_bn_relu_pairs(name)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bytes (so -0 is not 0)."""
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(-1).view(torch.uint8),
        b.contiguous().view(-1).view(torch.uint8)))


def _residual_case(c, train, dtype, seed):
    """(module, x, residual, dy) for a block's end: x and dy from
    ``_inputs``; the residual random but for a third of its elements, which
    cancel the BN's output exactly (the sum a tie at 0), and a sixth, which
    are -0 (as are a sixth of dy's)."""
    d = _inputs(c, seed=seed)
    m = BatchNorm2d(c).train(train)
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"),
                          ("running_mean", "mean"), ("running_var", "var")):
            getattr(m, name).copy_(torch.from_numpy(d[key]))
    nchw = (0, 3, 1, 2)
    x = torch.from_numpy(d["x"]).permute(*nchw).contiguous().to(dtype)
    dy = torch.from_numpy(d["dy"]).permute(*nchw).contiguous().to(dtype)
    g = torch.Generator().manual_seed(seed)
    r = torch.randn(x.shape, generator=g).to(dtype)
    with torch.no_grad():
        y = copy.deepcopy(m)(x)
    pick = torch.randint(0, 6, x.shape, generator=g)
    r = torch.where(pick < 2, -y, r)
    r = torch.where(pick == 2, torch.full_like(r, -0.0), r)
    dy = torch.where(pick == 3, torch.full_like(dy, -0.0), dy)
    return m, x, r, dy


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("train", [True, False])
def test_residual_form_equals_the_chain(train, precision):
    """``bn(x, residual=r)`` (the twin of the kernels' residual form) equals
    ``relu(bn(x) + r)``, the chain the blocks ran, bit for bit: output,
    the gradients of x, r, weight and bias, the running statistics; ties at
    0 where r cancels the BN output, -0 in r and dy. The backward wrapper
    given the saved output gives the same four gradients (the reference
    that chip phase 2d holds the kernels to)."""
    dtype = DTYPES[precision][0]
    m1, x, r, dy = _residual_case(8, train, dtype, seed=40 + train)
    m2 = copy.deepcopy(m1)
    x1, r1, x2, r2 = (t.clone().requires_grad_() for t in (x, r, x, r))
    before = (bn.batch_norm_train_cuda if train
              else bn.batch_norm_eval_cuda).residuals
    fused = m1(x1, residual=r1)
    counted = (bn.batch_norm_train_cuda if train
               else bn.batch_norm_eval_cuda).residuals - before
    chain = F.relu(m2(x2) + r2)
    assert counted == 1
    assert (fused == 0).any() and _bits_equal(fused, chain)
    fused.backward(dy)
    chain.backward(dy)
    for got, want in ((x1.grad, x2.grad), (r1.grad, r2.grad),
                      (m1.weight.grad, m2.weight.grad),
                      (m1.bias.grad, m2.bias.grad),
                      (m1.running_mean, m2.running_mean),
                      (m1.running_var, m2.running_var)):
        assert _bits_equal(got, want)
    s0, s1 = m2.running_mean, m2.running_var  # the twin reads these in eval
    before = bn.batch_norm_backward_cuda.residuals
    grads = bn.batch_norm_backward_cuda(dy, x, m2.weight, m2.bias, s0, s1,
                                        train, m2.eps, False,
                                        out=chain.detach())
    assert bn.batch_norm_backward_cuda.residuals == before + 1
    for got, want in zip(grads, (x2.grad, m2.weight.grad, m2.bias.grad,
                                 r2.grad)):
        assert _bits_equal(got, want)


def test_residual_form_refuses_a_relu_before_the_add():
    """A block's end takes its ReLU after the add: ``relu=True`` beside a
    residual is refused, not read as a second ReLU."""
    m, x, r, dy = _residual_case(4, True, torch.float32, seed=3)
    w = m.weight.detach()
    with pytest.raises(ValueError, match="relu must be False"):
        bn.batch_norm(x, w, w, m.running_mean, m.running_var,
                      m.num_batches_tracked, True, 0.1, 1e-5, True, r)
    with pytest.raises(ValueError, match="relu must be False"):
        bn.batch_norm_backward_cuda(dy, x, w, w, m.running_mean,
                                    m.running_var, False, 1e-5, True, out=r)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,ends", [("hrnet_tiny", 13),
                                       ("resnet50", 16)])
def test_residual_counter_counts_each_block_end(name, ends, train):
    """One forward ends every residual block in its last BatchNorm: 13 in
    HRNet-tiny (layer1's 4 Bottlenecks, 9 BasicBlocks), 16 in ResNet-50's
    Bottlenecks; counted by the wrapper of the mode, none by the other."""
    model = get_model(name).train(train)
    wrappers = (bn.batch_norm_train_cuda, bn.batch_norm_eval_cuda)
    before = [f.residuals for f in wrappers]
    with torch.no_grad():
        model(torch.zeros(2, 3, 64, 64))
    got = [f.residuals - b for f, b in zip(wrappers, before)]
    assert got == ([ends, 0] if train else [0, ends])


def _trace_family():
    """``benchmark/lhbench/trace.py:family``, read from its file (the
    benchmark's package is not on the import path of the tests)."""
    path = ROOT / "benchmark" / "lhbench" / "trace.py"
    spec = importlib.util.spec_from_file_location("_lhbench_trace", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclass looks itself up there
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules[spec.name]
    return module.family


def test_every_kernel_is_in_the_benchmarks_batch_norm_family():
    """``bn_ms.train`` sums the "batch norm" family: each ``__global__``
    of csrc/batch_norm.cu lands there, by its bare name and as the
    profiler names a template instance."""
    source = (_build.CSRC / "batch_norm.cu").read_text()
    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", source)
    assert sorted(names) == sorted(
        ["lh_bn_fw_partials", "lh_bn_fw_finalize", "lh_bn_fw_apply",
         "lh_bn_fw_eval", "lh_bn_bw_partials", "lh_bn_bw_finalize",
         "lh_bn_bw_apply"])
    family = _trace_family()
    for name in names:
        for shown in (name, f"void (anonymous namespace)::{name}"
                            f"<__nv_bfloat16, 8>(__nv_bfloat16 const*, "
                            f"long long, int, long long, float*)",
                      f"void (anonymous namespace)::{name}<float, 1>"
                      f"(float const*, float*, long long, int)"):
            assert family(shown) == "batch norm", shown


# every distinct (rows, C) of the cells' BatchNorms: HRNet-W32 at bs128,
# SimpleBaseline-R50 and HRNet-W48 at bs32, 256x256 inputs
CELL_SHAPES = sorted({(128 * h * w, c) for c, h, w in (
    (64, 128, 128), (64, 64, 64), (256, 64, 64), (32, 64, 64), (64, 32, 32),
    (32, 32, 32), (128, 16, 16), (32, 16, 16), (64, 16, 16), (256, 8, 8),
    (32, 8, 8), (64, 8, 8), (128, 8, 8))} | {(32 * h * w, c) for c, h, w in (
        (64, 128, 128), (64, 64, 64), (256, 64, 64), (128, 64, 64),
        (128, 32, 32), (512, 32, 32), (256, 32, 32), (256, 16, 16),
        (1024, 16, 16), (512, 16, 16), (512, 8, 8), (2048, 8, 8),
        (256, 128, 128),
        # HRNet-W48
        (64, 128, 128), (64, 64, 64), (256, 64, 64), (48, 64, 64),
        (48, 32, 32), (48, 16, 16), (48, 8, 8), (96, 32, 32), (96, 16, 16),
        (96, 8, 8), (192, 16, 16), (192, 8, 8), (384, 8, 8))})


@pytest.mark.parametrize("per_sm", [2, 3, 4])
@pytest.mark.parametrize("vec", [8, 4, 1])
def test_plan_covers_every_cell_shape(vec, per_sm):
    """On 132 SMs holding ``per_sm`` blocks each (the kernels' occupancy
    on an H100 is 2 to 4), for 4, 8 and 16 rows a thread loads at once
    (the library's ``lh_bn_rows``: 8 in the forward stages, 4 in the
    backward ones): the tiles cover the channels, the splits the rows (none
    empty), at most one wave of blocks, and at least a block an SM
    wherever the tensor has a row a thread for that many."""
    sms = 132
    for per_thread in (4, 8, 16):
        for rows, c in CELL_SHAPES:
            tc, tr, splits, chunk = bn.plan(rows, c, vec, sms, per_sm,
                                            per_thread)
            tiles = -(-(c // vec) // tc)
            assert tc * tr <= bn.THREADS and tiles * tc * vec >= c
            assert (splits - 1) * chunk < rows <= splits * chunk
            blocks = tiles * splits
            assert blocks <= sms * per_sm, (rows, c, per_thread)
            assert blocks >= min(sms, tiles * -(-rows // tr)), (rows, c)


def test_wrappers_take_no_twin_off_the_cpu():
    """A tensor on neither the CPU nor the card is refused, not handed to
    the twin: on any device but the CPU the wrappers launch or raise."""
    x = torch.zeros(2, 4, 3, 3, device="meta")
    w = torch.ones(4, device="meta")
    n = torch.zeros((), dtype=torch.long, device="meta")
    for call in (
            lambda: bn.batch_norm_train_cuda(x, w, w, w, w, n, 0.1, 1e-5,
                                             True),
            lambda: bn.batch_norm_eval_cuda(x, w, w, w, w, 1e-5, True),
            lambda: bn.batch_norm_backward_cuda(x, x, w, w, w, w, True, 1e-5,
                                                True)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
