"""The port's SimpleBaseline (PoseResNet) against the JAX package's.

Weights go JAX -> ``resnet_from_flax`` -> port; forward in f32 on the CPU at
64x64. Tolerances are those of tests/test_torch_models.py (atol 2e-4, rtol
1e-3): two frameworks' f32 convolutions sum in different orders. The
deconv head pins the kernel flip between Flax's ``ConvTranspose`` and
torch's (tests/test_transplant.py would check it against the reference
code, which is not in this repository).

In train mode every BatchNorm renormalises by the statistics of its batch,
so the two frameworks' last-ulp differences grow block by block. Measured
on resnet50 (batch 3, 64x64): max |diff| 5e-6 after the stem, 9e-5 after
layer1, 1.4e-3 after layer3 and 3.3e-3 after layer4, on activations of
magnitude 5-13; in eval mode every block agrees to 7e-7. So the train-mode
output of the 50-layer nets is held at atol 1e-2 (3x the measured 3.3e-3)
and their updated running stats (0.1 of the batch's) at atol 1e-3 (measured
1.3e-4); layer1, which the tighter tolerance still covers, is held at atol
2e-4 relative to its magnitude.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models.resnet import PoseResNet as JaxPoseResNet
from lighthand_tpu.utils.torch_port import (
    pose_resnet_from_torch,
    validate_against,
)
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.layers import BatchNorm2d, ConvTranspose2d
from lighthand_tpu_torch.models.resnet import PoseResNet
from lighthand_tpu_torch.utils.weights import resnet_from_flax

F32 = DTypePolicy.full_precision()
ATOL, RTOL = 2e-4, 1e-3
VARIANTS = {"resnet18": (18, False), "resnet50": (50, False),
            "resnet50_caffe": (50, True)}


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


def _jax_model(layers, caffe):
    return JaxPoseResNet(num_layers=layers, caffe_style=caffe,
                         policy=JaxPolicy.full_precision())


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """JAX PoseResNet (random init, BN stats and BN affine perturbed so both
    modes exercise them) and the port loaded from the same variables."""
    layers, caffe = VARIANTS[request.param]
    jmodel = _jax_model(layers, caffe)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(layers),
                                     jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(layers + caffe)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if a.ndim == 1 else a, variables["params"])
    return layers, caffe, jmodel, variables


def _port(layers, caffe, variables):
    port = PoseResNet(num_layers=layers, caffe_style=caffe, policy=F32)
    port.load_state_dict(resnet_from_flax(variables, layers))
    return port


def _input(seed, b=2, size=64):
    return np.random.default_rng(seed).normal(
        size=(b, size, size, 3)).astype(np.float32)


def _port_forward(port, x_nhwc, train):
    port.train(train)
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
    with torch.no_grad():
        return port(x).numpy()


def test_forward_eval_matches_jax(pair):
    layers, caffe, jmodel, variables = pair
    x = _input(0)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    got = _port_forward(_port(layers, caffe, variables), x, train=False)
    assert got.dtype == np.float32 and got.shape == (2, 21, 16, 16)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)


def test_forward_train_and_batch_stats_match_jax(pair):
    """Train mode normalises with batch statistics and updates the running
    stats with Flax's rule (biased variance, momentum 0.9)."""
    layers, caffe, jmodel, variables = pair
    port = _port(layers, caffe, variables)
    x = _input(1, b=3)
    want, mutated = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats", "intermediates"],
                                 capture_intermediates=True)
    layer1 = {}

    def keep(module, inputs, out):
        layer1["out"] = out.numpy()

    port.layer1.register_forward_hook(keep)
    got = _port_forward(port, x, train=True)
    atol = ATOL if layers == 18 else 1e-2
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               atol=atol, rtol=RTOL)
    last = len(port.layer1) - 1
    want1 = np.asarray(mutated["intermediates"][f"layer1_block{last}"]
                       ["__call__"][0]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(layer1["out"] / np.abs(want1).max(),
                               want1 / np.abs(want1).max(), atol=ATOL, rtol=0)

    want_sd = resnet_from_flax({"params": variables["params"],
                                "batch_stats": _np_tree(
                                    mutated["batch_stats"])}, layers)
    got_sd = port.state_dict()
    stats = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, BatchNorm2d)
                                 for m in port.modules())
    stat_atol = 1e-5 if layers == 18 else 1e-3
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   atol=stat_atol, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("cin,cout", [(8, 4), (4, 4)])
def test_deconv_matches_flax_conv_transpose(cin, cout):
    """torch ConvTranspose2d(4, 2, p=1) on the flipped kernel is Flax's
    ConvTranspose(4, 2, "SAME") on the stored one; without the flip the two
    differ by far more than f32 noise."""
    rng = np.random.default_rng(cin)
    kernel = rng.normal(size=(4, 4, cin, cout)).astype(np.float32)
    x = rng.normal(size=(2, 5, 6, cin)).astype(np.float32)
    flax_deconv = fnn.ConvTranspose(cout, (4, 4), strides=(2, 2),
                                    padding="SAME", use_bias=False)
    want = np.asarray(flax_deconv.apply({"params": {"kernel": kernel}}, x))
    deconv = ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        deconv.weight.copy_(torch.from_numpy(kernel).flip(0, 1)
                            .permute(2, 3, 0, 1))
        got = deconv(xt).permute(0, 2, 3, 1).numpy()
        deconv.weight.copy_(torch.from_numpy(kernel).permute(2, 3, 0, 1))
        unflipped = deconv(xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 10, 12, cout)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(unflipped - want).max() > 0.1


def _template(layers, caffe=False):
    return jax.eval_shape(
        lambda k: _jax_model(layers, caffe).init(
            k, jnp.zeros((1, 64, 64, 3)), train=False),
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("name,layers", [("resnet18", 18),
                                         ("simplebaseline", 50)])
def test_state_dict_is_the_reference_layout(name, layers):
    """The port's state_dict names are the reference's: the JAX package's
    importer consumes them all and builds exactly the Flax tree."""
    sd = {k: v.numpy() for k, v in get_model(name).state_dict().items()}
    validate_against(pose_resnet_from_torch(sd, layers), _template(layers))


@pytest.mark.parametrize("layers,caffe", [(18, False), (50, True)])
def test_flax_torch_flax_is_identity(layers, caffe):
    rng = np.random.default_rng(layers)
    variables = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        _template(layers, caffe))
    sd = resnet_from_flax(variables, layers)
    # strict: every key, no extra
    PoseResNet(num_layers=layers, caffe_style=caffe).load_state_dict(sd)
    back = pose_resnet_from_torch({k: v.numpy() for k, v in sd.items()},
                                  layers)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path], err_msg=str(path))


@pytest.mark.parametrize("name,layers,params", [
    ("resnet18", 18, 15_377_749), ("simplebaseline", 50, 34_000_725),
    ("resnet50", 50, 34_000_725)])
def test_get_model_param_counts_match_jax(name, layers, params):
    port = get_model(name)
    assert isinstance(port, PoseResNet)
    assert sum(p.numel() for p in port.parameters()) == params
    leaves = jax.tree_util.tree_leaves(_template(layers)["params"])
    assert sum(int(np.prod(x.shape)) for x in leaves) == params


def test_get_model_resnet_names_and_joints():
    assert len(get_model("resnet").layer3) == 6  # resnet50: (3, 4, 6, 3)
    assert len(get_model("resnet34").layer3) == 6
    assert len(get_model("resnet101").layer3) == 23
    assert get_model("resnet18", num_joints=14).final_layer.out_channels == 14


def test_bf16_policy_dtypes():
    """bf16 policy: params f32, convs and the deconv head in bf16, BN output
    cast to bf16, logits f32 (lighthand_tpu/models/resnet.py:91,126)."""
    port = get_model("resnet18").eval()
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen[name] = output.dtype
        return hook

    port.conv1.register_forward_hook(record("conv"))
    port.bn1.register_forward_hook(record("bn"))
    port.deconv_layers[0].register_forward_hook(record("deconv"))
    with torch.no_grad():
        out = port(torch.zeros(1, 3, 32, 32))
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert seen == {"conv": torch.bfloat16, "bn": torch.bfloat16,
                    "deconv": torch.bfloat16}
    assert out.dtype == torch.float32 and out.shape == (1, 21, 8, 8)


def test_seeded_init_draws_the_deconv_head():
    """create_train_state's init covers the transposed convs: torch's
    default bound 1/sqrt(fan_in), fan_in from the output channels."""
    from lighthand_tpu_torch.models.layers import init_weights

    a, b = get_model("resnet18"), get_model("resnet18")
    init_weights(a, torch.Generator().manual_seed(1))
    init_weights(b, torch.Generator().manual_seed(1))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    w = a.deconv_layers[3].weight  # [256, 256, 4, 4]
    assert 0 < w.abs().max() <= 1 / np.sqrt(256 * 16)
