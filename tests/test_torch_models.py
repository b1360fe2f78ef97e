"""The port's HRNet against the JAX package's, on the same weights.

Weights go JAX -> ``hrnet_from_flax`` -> port; forward in f32 on the CPU.
Tolerances are those of tests/test_transplant.py:71-72 (atol 2e-4,
rtol 1e-3): two frameworks' f32 convolutions sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.models.hrnet import HRNetCfg as JaxHRNetCfg
from lighthand_tpu.utils.torch_port import (
    pose_hrnet_from_torch,
    validate_against,
)
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.models.layers import BatchNorm2d
from lighthand_tpu_torch.utils.weights import hrnet_from_flax

F32 = DTypePolicy.full_precision()
ATOL, RTOL = 2e-4, 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tiny_pair():
    """JAX hrnet_tiny (random init, then BN stats perturbed so eval mode
    exercises them) and the port loaded from the same variables."""
    jmodel = jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision())
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(3),
                                     jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, variables["params"])
    port = get_model("hrnet_tiny", policy=F32)
    port.load_state_dict(hrnet_from_flax(variables, HRNetCfg.tiny()))
    return jmodel, variables, port


def _input(seed, b=2, size=64):
    return np.random.default_rng(seed).normal(
        size=(b, size, size, 3)).astype(np.float32)


def _port_forward(port, x_nhwc, train):
    port.train(train)
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.no_grad():
        return port(x).numpy()


def test_tiny_forward_eval_matches_jax(tiny_pair):
    jmodel, variables, port = tiny_pair
    x = _input(0)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    got = _port_forward(port, x, train=False)
    assert got.dtype == np.float32 and got.shape == (2, 21, 16, 16)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)


def test_tiny_forward_train_and_batch_stats_match_jax(tiny_pair):
    """Train-mode forward normalises with batch statistics and updates the
    running stats with Flax's rule (biased variance, momentum 0.9)."""
    jmodel, variables, port = tiny_pair
    port = get_model("hrnet_tiny", policy=F32)
    port.load_state_dict(hrnet_from_flax(variables, HRNetCfg.tiny()))
    x = _input(1, b=3)
    want, mutated = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
    got = _port_forward(port, x, train=True)
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)

    new_vars = {"params": variables["params"],
                "batch_stats": _np_tree(mutated["batch_stats"])}
    want_sd = hrnet_from_flax(new_vars, HRNetCfg.tiny())
    got_sd = port.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm2d)
                                 for m in port.modules())
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def test_batchnorm_running_var_is_biased():
    """Flax updates the running variance with the biased batch variance;
    nn.BatchNorm2d would use the unbiased one (x n/(n-1), ~1% here)."""
    bn = BatchNorm2d(4).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        2.0, 3.0, size=(2, 4, 3, 3)).astype(np.float32))
    bn(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * biased)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))


def test_bf16_policy_dtypes():
    """bf16 policy: params f32, convs in bf16, BN output cast to bf16,
    logits f32 (lighthand_tpu/models/hrnet.py:166,207)."""
    port = get_model("hrnet_tiny").eval()
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen[name] = output.dtype
        return hook

    port.conv1.register_forward_hook(record("conv"))
    port.bn1.register_forward_hook(record("bn"))
    with torch.no_grad():
        out = port(torch.zeros(1, 3, 32, 32))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert seen == {"conv": torch.bfloat16, "bn": torch.bfloat16}
    assert out.dtype == torch.float32


@pytest.fixture(scope="module")
def w32_template():
    model = jax_get_model("hrnet_w32", policy=JaxPolicy.full_precision())
    return jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))


def test_w32_state_dict_is_the_reference_layout(w32_template):
    """The port's state_dict names are the reference's: the JAX package's
    importer consumes them all and builds exactly the W32 Flax tree."""
    sd = {k: v.numpy() for k, v in get_model("hrnet_w32").state_dict().items()}
    validate_against(pose_hrnet_from_torch(sd), w32_template)


def test_w32_flax_torch_flax_is_identity(w32_template):
    rng = np.random.default_rng(7)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), w32_template)
    sd = hrnet_from_flax(variables, HRNetCfg.w32())
    get_model("hrnet_w32").load_state_dict(sd)  # strict: every key, no extra
    back = pose_hrnet_from_torch({k: v.numpy() for k, v in sd.items()},
                                 JaxHRNetCfg.w32())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


@pytest.mark.parametrize("name,params", [("hrnet_w32", 28_536_245),
                                         ("hrnet_tiny", 544_541)])
def test_get_model_param_counts_match_jax(name, params, w32_template):
    port = get_model(name)
    assert sum(p.numel() for p in port.parameters()) == params
    if name == "hrnet_w32":
        leaves = jax.tree_util.tree_leaves(w32_template["params"])
        assert sum(int(np.prod(x.shape)) for x in leaves) == params


def test_get_model_unknown_name():
    with pytest.raises(ValueError):
        get_model("vgg16")
