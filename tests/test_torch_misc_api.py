"""The port's misc and state helpers (``utils/misc.py``, ``train/state.py``,
``train/profiler.py:annotate``, ``core/mesh.py:local_device_count``) and
its package re-exports against the JAX package's, on the CPU.

The masked Adam step runs hrnet_tiny (64x64, 16x16 maps, f32) from the same
weights in both packages (JAX init -> ``hrnet_from_flax``), one fused step
with aug off, at lr 1e-4: frozen parameters bit-unchanged in both, the
trainable ones within 2 * lr of each other, the running statistics within
5e-3 (the tolerances of tests/test_torch_step.py for its steps). JAX's
``create_train_state`` takes no optimizer, so the test puts JAX's
``masked_optimizer`` into its state itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import lighthand_tpu
import lighthand_tpu_torch
from lighthand_tpu.config import Config as JaxConfig
from lighthand_tpu.config import parse_args as jax_parse_args
from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.train import create_train_state as jax_create_state
from lighthand_tpu.train import state as jstate_mod
from lighthand_tpu.train.step import make_fused_train_step as jax_fused_step
from lighthand_tpu.utils import misc as jmisc
from lighthand_tpu_torch.config import Config, parse_args
from lighthand_tpu_torch.core import mesh
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.train import profiler
from lighthand_tpu_torch.train.checkpoint import (
    resume_checkpoint,
    save_checkpoint,
)
from lighthand_tpu_torch.train.state import (
    ShardAdam,
    create_train_state,
    make_optimizer,
    param_count,
)
from lighthand_tpu_torch.train.step import make_fused_train_step
from lighthand_tpu_torch.utils import misc
from lighthand_tpu_torch.utils.weights import hrnet_from_flax

LR = 1e-4
PARAM_ATOL, STAT_ATOL = 2 * LR, 5e-3
# the stem and layer1 (the reference's freeze_weights names), and the same
# layers by their Flax paths
PORT_FROZEN = [r"^(conv1|bn1|conv2|bn2|layer1)\."]
JAX_FROZEN = [r"^(stem1|stem2|layer1_block\d+)/"]
T = torch.from_numpy


def _variables(jstate):
    return jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        {"params": jstate.params, "batch_stats": jstate.batch_stats})


def _jax_state(name="hrnet_tiny"):
    return jax_create_state(jax_get_model(name,
                                          policy=JaxPolicy.full_precision()),
                            jax.random.PRNGKey(0), input_shape=(1, 64, 64, 3),
                            lr=LR)


def _port_model(jstate):
    model = get_model("hrnet_tiny", policy=DTypePolicy.full_precision())
    model.load_state_dict(hrnet_from_flax(_variables(jstate),
                                          HRNetCfg.tiny()))
    return model


# ------------------------------------------------------------ config io


@pytest.mark.parametrize("argv", [None, ["--root", "hrnet/ours", "--name",
                                         "ft", "--epoch", "7", "--batch_size",
                                         "16", "--flip", "--rot-aug", "15"]],
                         ids=["default", "parse_args"])
def test_save_config_writes_jaxs_yaml(argv, tmp_path):
    """The same file as JAX's, less the port-only ``platform`` key."""
    port_cfg = Config() if argv is None else parse_args(argv)
    jax_cfg = JaxConfig() if argv is None else jax_parse_args(argv)
    got = misc.save_config(port_cfg, str(tmp_path / "port"))
    want = jmisc.save_config(jax_cfg, str(tmp_path / "jax"))
    assert got.endswith("port/config.yaml")
    with open(got) as f:
        text = f.read()
    with open(want) as f:
        want_text = f.read()
    assert "platform: null\n" in text
    assert text.replace("platform: null\n", "") == want_text
    loaded = misc.load_yaml(got)
    assert loaded == dataclasses.asdict(port_cfg)  # the round trip
    assert loaded == {**jmisc.load_yaml(want), "platform": None}


def test_save_config_takes_a_mapping_and_a_name(tmp_path):
    path = misc.save_config({"b": [1, 2], "a": {"c": 0.5}},
                            str(tmp_path / "x" / "y"), name="run.yaml")
    assert path == str(tmp_path / "x" / "y" / "run.yaml")
    with open(path) as f:
        assert yaml.safe_load(f) == {"a": {"c": 0.5}, "b": [1, 2]}
    misc.mkdir(str(tmp_path / "x" / "y"))  # exists: no error


def test_try_once_prints_jaxs_message(capsys):
    def boom(x):
        raise KeyError(x)

    def fine(x):
        return x + 1

    assert misc.try_once(boom)("k") is None
    port_out = capsys.readouterr().out
    assert jmisc.try_once(boom)("k") is None
    assert port_out == capsys.readouterr().out == \
        "[try_once] boom failed: 'k'\n"
    assert misc.try_once(fine)(1) == 2 and misc.try_once(fine).__name__ == \
        "fine"


def test_config_iteration_reads_a_port_checkpoint(tmp_path):
    state = create_train_state(get_model("hrnet_tiny"),
                               torch.Generator().manual_seed(0), lr=LR,
                               device="cpu")
    out = str(tmp_path / "run")
    assert misc.config_iteration(out) == 0  # no marker yet
    save_checkpoint(state, out, epoch=7, best_loss=0.5, count=2)
    assert misc.config_iteration(out) == 7
    assert jmisc.config_iteration(out) == 7  # the JAX reader agrees


# ---------------------------------------------------------------- state


@pytest.mark.parametrize("name", ["hrnet_tiny", "resnet18"])
def test_param_count_matches_jax(name):
    port = create_train_state(get_model(name), lr=LR, device="cpu")
    assert param_count(port) == jstate_mod.param_count(_jax_state(name))


def test_make_optimizer_and_apply_gradients():
    model = torch.nn.Linear(3, 2)
    state = create_train_state(model, lr=0.1, device="cpu")
    assert isinstance(state.optimizer, ShardAdam)
    assert state.optimizer.defaults["lr"] == 0.1
    assert state.optimizer.defaults["betas"] == (0.9, 0.999)
    assert state.optimizer.defaults["eps"] == 1e-8
    before = model.weight.detach().clone()
    model(torch.ones(1, 3)).sum().backward()
    assert state.apply_gradients() is state and state.step == 1
    assert not torch.equal(model.weight, before)
    opt = make_optimizer([torch.nn.Parameter(torch.ones(2))], lr=0.5)
    assert isinstance(opt, ShardAdam) and opt.defaults["lr"] == 0.5


def _flax_frozen_names(jstate, mask) -> set:
    """The port's names of the parameters JAX's mask freezes: the mask as
    0/1 arrays, carried through the same Flax -> torch map as the
    weights."""
    ones = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, float(m), np.float32), mask,
        jstate.params)
    sd = hrnet_from_flax({"params": ones,
                          "batch_stats": _variables(jstate)["batch_stats"]},
                         HRNetCfg.tiny())
    named = dict(get_model("hrnet_tiny").named_parameters())
    frozen = {k for k, v in sd.items() if k in named and float(v.max()) == 0}
    assert all(float(sd[k].min()) == 1.0 for k in set(named) - frozen)
    return frozen


def test_masked_adam_step_matches_jax():
    jstate = _jax_state()
    pmodel = _port_model(jstate)
    jmask = jmisc.freeze_mask(jstate.params, JAX_FROZEN)
    pmask = misc.freeze_mask(pmodel, PORT_FROZEN)
    frozen = {k for k, v in pmask.items() if not v}
    assert frozen == _flax_frozen_names(jstate, jmask)
    assert len(frozen) == 2 * 3 + 4 * (3 * 3) + 3  # stem, 4 blocks, a down

    tx = jmisc.masked_optimizer(optax.adam(LR), jmask)
    jstate = jstate.replace(tx=tx, opt_state=tx.init(jstate.params))
    pstate = create_train_state(pmodel, lr=LR, device="cpu",
                                trainable=pmask)
    start = {k: v.detach().clone() for k, v in
             pstate.model.state_dict().items()}
    jstart = _variables(jstate)

    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    joints = rng.uniform(8, 56, size=(4, 21, 2)).astype(np.float32)
    off = np.zeros(4, np.float32)
    jstate, jm = jax_fused_step(heatmap_size=16, stride=4.0, jitter=True,
                                compute_dtype=jnp.float32,
                                use_pallas_aug=False)(
        jstate, jax.random.PRNGKey(0), {"image_u8": jnp.asarray(images),
                                        "joints": jnp.asarray(joints),
                                        "aug_enabled": jnp.asarray(off)})
    pstate, pm = make_fused_train_step(
        heatmap_size=16, compute_dtype=torch.float32, device="cpu")(
        pstate, torch.Generator().manual_seed(0),
        {"image_u8": T(images), "joints": T(joints), "aug_enabled": T(off),
         "noise_enabled": T(off)})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)

    # frozen: bit-unchanged in both packages; trainable: moved, and agreed
    jflat = dict(zip(
        ["/".join(str(getattr(k, "key", k)) for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(jstate.params)[0]],
        jax.tree_util.tree_leaves(jstate.params)))
    jstart_flat = dict(zip(jflat, jax.tree_util.tree_leaves(
        jstart["params"])))
    jfrozen = {k for k, m in zip(jflat, jax.tree_util.tree_leaves(jmask))
               if not m}
    for k in jflat:
        same = np.array_equal(np.asarray(jflat[k]), jstart_flat[k])
        assert same == (k in jfrozen), k
    want = hrnet_from_flax(_variables(jstate), HRNetCfg.tiny())
    got = pstate.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in frozen:
            assert torch.equal(got[k], start[k]), k
            assert pstate.model.get_parameter(k).grad is None, k
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=STAT_ATOL if stat else PARAM_ATOL,
                                   err_msg=k)
        assert not torch.equal(got[k], start[k]), k  # moved or updated
    # a frozen layer's BatchNorm statistics keep updating, as Flax's do
    assert not torch.equal(got["bn1.running_mean"], start["bn1.running_mean"])


def test_frozen_parameters_hold_no_gradient_and_no_moments():
    """A frozen parameter gets ``requires_grad_(False)``: backward leaves
    no gradient to pile up from step to step, and Adam keeps no moments
    for it."""
    model = get_model("hrnet_tiny", policy=DTypePolicy.full_precision())
    mask = misc.freeze_mask(model, PORT_FROZEN)
    state = create_train_state(model, torch.Generator().manual_seed(0),
                               lr=1e-3, device="cpu", trainable=mask)
    step = make_fused_train_step(heatmap_size=16, device="cpu",
                                 compute_dtype=torch.float32)
    rng = np.random.default_rng(2)
    batch = {"image_u8": T(rng.integers(0, 256, size=(2, 64, 64, 3),
                                        dtype=np.uint8)),
             "joints": T(rng.uniform(8, 56, size=(2, 21, 2))
                         .astype(np.float32)),
             "aug_enabled": torch.ones(2)}
    n = param_count(state)
    for _ in range(2):
        state, _ = step(state, torch.Generator().manual_seed(1), batch)
    assert state.step == 2 and param_count(state) == n
    owned = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        assert p.requires_grad == mask[name]
        assert (id(p) in owned) == mask[name]
        if not mask[name]:
            assert p.grad is None and p not in state.optimizer.state, name


def test_masked_optimizer_checks_its_mask():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.Linear(2, 1))
    mask = misc.freeze_mask(model, [r"^0\."])
    assert mask == {"0.weight": False, "0.bias": False, "1.weight": True,
                    "1.bias": True}
    with pytest.raises(ValueError, match="unknown.*typo"):
        misc.masked_optimizer(model, {**mask, "typo": True})
    with pytest.raises(ValueError, match="absent.*1.bias"):
        misc.masked_optimizer(model, {k: v for k, v in mask.items()
                                      if k != "1.bias"})
    with pytest.raises(ValueError, match="every parameter"):
        misc.masked_optimizer(model, dict.fromkeys(mask, False))
    opt = misc.masked_optimizer(model, mask, lr=0.2)
    assert [p.shape for p in opt.param_groups[0]["params"]] == [(1, 2), (1,)]
    assert opt.defaults["lr"] == 0.2


def test_masked_state_checkpoint_round_trip(tmp_path):
    model = get_model("hrnet_tiny", policy=DTypePolicy.full_precision())
    mask = misc.freeze_mask(model, PORT_FROZEN)

    def fresh():
        m = get_model("hrnet_tiny", policy=DTypePolicy.full_precision())
        return create_train_state(m, torch.Generator().manual_seed(0),
                                  lr=1e-3, device="cpu",
                                  trainable=misc.freeze_mask(m, PORT_FROZEN))

    state = fresh()
    for p in state.model.parameters():
        p.grad = torch.ones_like(p) if p.requires_grad else None
    state.apply_gradients()
    out = str(tmp_path / "run")
    save_checkpoint(state, out, epoch=3, best_loss=0.25, count=1)
    loaded = fresh()
    best, start, loaded, count = resume_checkpoint(loaded, out)
    assert (best, start, count, loaded.step) == (0.25, 4, 1, 1)
    for (name, p), q in zip(loaded.model.named_parameters(),
                            state.model.parameters()):
        assert torch.equal(p, q), name
        assert p.requires_grad == mask[name]
        want = state.optimizer.state.get(q, {})
        got = loaded.optimizer.state.get(p, {})
        assert sorted(got) == sorted(want), name
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


# ----------------------------------------------------- profiler, devices


def test_annotate_is_a_range_in_a_cpu_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.annotate("lighthand_eval_region"):
            torch.ones(8).add_(1)
    keys = [e.key for e in prof.key_averages()]
    assert "lighthand.lighthand_eval_region" in keys


def test_local_device_count():
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert mesh.local_device_count() == want


# ------------------------------------------------------------ re-exports


def test_package_re_exports_match_jaxs():
    import lighthand_tpu.core as jcore
    import lighthand_tpu.data as jdata
    import lighthand_tpu.ops as jops
    import lighthand_tpu_torch.core as pcore
    import lighthand_tpu_torch.data as pdata
    import lighthand_tpu_torch.ops as pops
    from lighthand_tpu_torch.data.pipeline import DevicePreprocessor
    from lighthand_tpu_torch.ops import decode, heatmap, metrics, procrustes

    assert lighthand_tpu_torch.ops is pops and lighthand_tpu.ops is jops
    assert pops.__all__ == jops.__all__
    homes = (decode, heatmap, metrics, procrustes)
    for name in pops.__all__:
        fn = getattr(pops, name)
        assert any(getattr(m, name, None) is fn for m in homes), name
    for name in ("MeshSpec", "create_mesh", "is_host_leader"):
        assert getattr(pcore, name) is getattr(mesh, name)
        assert name in pcore.__all__ and name in jcore.__all__
    assert pdata.DevicePreprocessor is DevicePreprocessor
    assert "DevicePreprocessor" in pdata.__all__
    assert set(jdata.__all__) <= set(pdata.__all__)
