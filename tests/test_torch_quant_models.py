"""The port's models under the int8_fwd and all_bf16 policies against the
JAX package's, on the CPU (the int8 kernel's wrapper computes its plain
twin there). The conv itself and the policies' plumbing are held in
tests/test_torch_quant.py.

Measured here (and held as stated):

- The eval-mode forward of resnet18 and hrnet_tiny under the int8 policy,
  JAX's weights (BN stats perturbed) loaded through ``utils/weights.py``:
  max |diff| 0.0 in bf16 and in f32 compute, at 64x64 and at the 32x32
  the test uses. Held at atol 1e-5 (the f32 head and final convs may sum
  in another order on another build).
- all_bf16: bit-identical to bf16 in both packages, in train and eval mode.
- A model's forward under int8_fwd quantizes every ``QuantConv2d`` weight
  in one grouped call (one kernel launch on the card), in ``modules()``
  order, and no conv quantizes its own weight; no ``w_q`` outlives it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.models.layers import Conv2d, QuantConv2d
from lighthand_tpu_torch.ops import quant
from lighthand_tpu_torch.train import create_train_state, make_fused_train_step
from lighthand_tpu_torch.utils.weights import hrnet_from_flax, resnet_from_flax

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    torch's default of one thread per core oversubscribes the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _jax_variables(name):
    """JAX variables (every policy has the same tree; initialised under
    the f32 one, BN stats perturbed) and the port's state_dict of them."""
    jm = jax_get_model(name, policy=JaxPolicy.full_precision())
    v = _np_tree(jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    sd = (resnet_from_flax(v, 18) if name == "resnet18"
          else hrnet_from_flax(v, HRNetCfg.tiny()))
    return v, sd


def _count_quant(model):
    return sum(isinstance(m, QuantConv2d) for m in model.modules())


@pytest.mark.parametrize("name", ["resnet18", "hrnet_tiny"])
def test_int8_state_dict_matches_bf16(name):
    """int8_fwd shares checkpoints with bf16: the same keys and shapes, and
    a bf16 state_dict loads into the int8 model."""
    bf = get_model(name)
    q = get_model(name, policy=DTypePolicy.int8_fwd())
    assert ({k: v.shape for k, v in bf.state_dict().items()}
            == {k: v.shape for k, v in q.state_dict().items()})
    q.load_state_dict(bf.state_dict())


@pytest.mark.parametrize("name,want", [("resnet50", 53), ("hrnet_w32", 292),
                                       ("resnet18", None),
                                       ("hrnet_tiny", None)])
def test_quantized_convs_are_the_jax_convbn_convs(name, want):
    """Every conv JAX wraps in ConvBN is quantized, and nothing else: the
    count equals the JAX int8 model's ConvBN kernels (the deconvs and
    the final 1x1 stay float)."""
    model = get_model(name, policy=DTypePolicy.int8_fwd())
    n = _count_quant(model)
    plain = [m for m in model.modules()
             if isinstance(m, Conv2d) and not isinstance(m, QuantConv2d)]
    assert len(plain) == 1 and plain[0] is model.final_layer
    if want is not None:
        assert n == want
        return
    params = jax.eval_shape(
        lambda: jax_get_model(name, policy=JaxPolicy.int8_fwd()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            train=False))["params"]
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    convbn = [p for p in paths if any(getattr(k, "key", None) == "Conv_0"
                                      for k in p)]
    assert n == len(convbn)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["resnet18", "hrnet_tiny"])
def test_int8_forward_matches_jax(name, dtype):
    jdt, tdt = DTYPES[dtype]
    v, sd = _jax_variables(name)
    jm = jax_get_model(name, policy=JaxPolicy(compute_dtype=jdt,
                                              quant_fwd=True))
    model = get_model(name, policy=DTypePolicy(compute_dtype=tdt,
                                               quant_fwd=True)).eval()
    model.load_state_dict(sd)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["resnet18", "hrnet_tiny"])
def test_int8_forward_quantizes_once(name, train, monkeypatch):
    """One grouped call a forward, over every QuantConv2d weight in
    ``modules()`` order, outside autograd; no single-weight call; no
    ``w_q`` left on a module afterwards; the training forward's gradient
    still reaches every weight (the straight-through backward)."""
    groups, singles = [], []
    grouped, single = quant.quantize_weights_cuda, quant.quantize_weight_cuda

    def spy_group(ws, act_clip):
        groups.append((list(ws), torch.is_grad_enabled()))
        return grouped(ws, act_clip)

    def spy_single(w, act_clip):
        singles.append(w)
        return single(w, act_clip)

    monkeypatch.setattr(quant, "quantize_weights_cuda", spy_group)
    monkeypatch.setattr(quant, "quantize_weight_cuda", spy_single)
    model = get_model(name, policy=DTypePolicy.int8_fwd()).train(train)
    convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 3, 32, 32)).astype(np.float32))
    with torch.set_grad_enabled(train):
        y = model(x)
    assert len(groups) == 1 and not singles
    ws, grad_on = groups[0]
    assert len(ws) == len(convs) > 0 and not grad_on
    assert all(w is m.weight for w, m in zip(ws, convs))
    assert all(m.quantized is None for m in convs)
    if train:
        y.float().square().mean().backward()
        assert all(m.weight.grad is not None and m.weight.grad.abs().sum() > 0
                   for m in convs)


def test_int8_policy_trains():
    """Fused step under int8_fwd: the loss finite and falling (the forward
    is lossy, the gradient the float one)."""
    torch.manual_seed(0)
    state = create_train_state(
        get_model("resnet18", policy=DTypePolicy.int8_fwd()),
        torch.Generator().manual_seed(0), lr=1e-3, device="cpu")
    step = make_fused_train_step(heatmap_size=16, stride=4.0, jitter=False,
                                 device="cpu")
    rng = np.random.default_rng(6)
    batch = {"image_u8": torch.from_numpy(rng.integers(
                 0, 256, size=(4, 64, 64, 3), dtype=np.uint8)),
             "joints": torch.from_numpy(rng.uniform(
                 8, 56, size=(4, 21, 2)).astype(np.float32)),
             "aug_enabled": torch.zeros(4)}
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(state, gen, batch)[1]["loss"]) for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["resnet18", "hrnet_tiny"])
def test_all_bf16_equals_bf16_in_both_packages(name, train):
    """Flax's BatchNorm(dtype=bf16) reduces and normalises in f32 and casts
    the result; the port's BatchNorm2d does the same for either policy."""
    x = np.random.default_rng(7).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    v, sd = _jax_variables(name)
    outs = []
    for policy in (JaxPolicy(), JaxPolicy.all_bf16()):
        jm = jax_get_model(name, policy=policy)
        y = jax.jit(lambda v_, x_: jm.apply(
            v_, x_, train=train,
            **({"mutable": ["batch_stats"]} if train else {})))(
                v, jnp.asarray(x))
        outs.append(np.asarray(y[0] if train else y))
    np.testing.assert_array_equal(outs[0], outs[1])
    outs = []
    for policy in (DTypePolicy(), DTypePolicy.all_bf16()):
        model = get_model(name, policy=policy).train(train)
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert torch.equal(outs[0], outs[1])
