"""``tools/orbax_to_torch.py``: a run of the JAX package (orbax checkpoint)
converted into the port's layout, on the CPU.

- The converted run, read by ``lighthand_tpu_torch.cli.eval``, gives the
  JAX eval CLI's ``evaluation.json`` and ``pck_eval_*.txt`` (hrnet_tiny,
  f32, BN statistics perturbed so the maps have clear peaks, as in
  ``tests/test_torch_eval.py``).
- The converted Adam state is JAX's ``mu`` / ``nu`` through the weight
  mapping, exactly, with optax's ``count`` as every ``step``.
- One port step after resuming the converted checkpoint equals one JAX
  step after ``resume_checkpoint``: the loss within 1e-5 relative, the
  parameters within 2 lr (``tests/test_torch_step.py``'s one-step bound),
  and Adam's moments after the step, 0.9 (0.999) of the converted ``mu``
  (``nu``) plus the new gradient's share, within 2e-2 of each tensor's
  largest value (measured 3.0e-3 / 2.8e-3: the two frameworks' gradients
  of hrnet_tiny at 64x64, batch 4, differ by 1.6e-3 in norm, a median
  over tensors, as its train-mode BatchNorm over a few values a channel
  amplifies f32 noise; a 1e-7 relative change of the input moves the
  port's own gradients by up to 2.2e-3). A ``mu`` or ``nu`` not carried
  across is off by ~0.9 (~1.0) of that largest value.
- The converter raises on a model record that the checkpoint does not
  match, and where no record names the model.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fixtures
from lighthand_tpu.cli import eval as jax_cli
from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.train import create_train_state as jax_create_state
from lighthand_tpu.train.checkpoint import resume_checkpoint as jax_resume
from lighthand_tpu.train.checkpoint import save_checkpoint as jax_save
from lighthand_tpu.train.step import make_fused_train_step as jax_fused_step
from lighthand_tpu_torch.cli import eval as cli
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.train import create_train_state, make_fused_train_step
from lighthand_tpu_torch.train.checkpoint import resume_checkpoint
from lighthand_tpu_torch.utils.weights import hrnet_from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ("runs", "hrnet", "ours", "x")
LR = 1e-4
MOMENT_RTOL = 2e-2
INFO = {"name": "hrnet_tiny", "precision": "f32"}


def _converter():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, size=(4, 64, 64, 3),
                                     dtype=np.uint8),
            "joints": rng.uniform(8, 56, size=(4, 21, 2)).astype(np.float32),
            "aug_enabled": np.zeros(4, np.float32)}


def _jax_step():
    return jax_fused_step(heatmap_size=16, stride=4.0, jitter=True,
                          compute_dtype=jnp.float32, use_pallas_aug=False)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny JAX run: hrnet_tiny after two Adam steps (so mu, nu and
    count are not their initial values), BN statistics perturbed, saved by
    the JAX package's save_checkpoint (orbax) and converted."""
    jstate = jax_create_state(
        jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision()),
        jax.random.PRNGKey(0), input_shape=(1, 32, 32, 3), lr=LR)
    step = _jax_step()
    for i in range(2):
        jstate, _ = step(jstate, jax.random.PRNGKey(i),
                         {k: jnp.asarray(v) for k, v in _batch(i).items()})
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.0, 0.5, a.shape))
        .astype(np.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    root = tmp_path_factory.mktemp("orbax")
    jdir, pdir = root / "jax", root / "port"
    jrun, prun = str(jdir.joinpath(*RUN)), str(pdir.joinpath(*RUN))
    jax_save(jstate, jrun, 1, 0.25, 3, model_info=INFO)
    assert _converter().main([jrun, prun]) == 0
    return jdir, pdir, jrun, prun, jstate


def test_converted_run_files(run):
    _, _, _, prun, jstate = run
    with open(os.path.join(prun, "last_checkpoint.json")) as f:
        marker = json.load(f)
    assert marker["epoch"] == 1 and marker["model"] == INFO
    payload = torch.load(os.path.join(prun, "checkpoint-good", "state.pt"),
                         weights_only=True)
    assert (payload["epoch"], payload["best_loss"], payload["count"],
            payload["step"]) == (1, 0.25, 3, 2)
    want = hrnet_from_flax(_np({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}),
                           HRNetCfg.tiny())
    assert sorted(payload["model"]) == sorted(want)
    for k, v in want.items():
        assert torch.equal(payload["model"][k], v), k
    groups = payload["optimizer"]["param_groups"]
    assert len(groups) == 1 and groups[0]["lr"] == pytest.approx(LR)
    adam = jstate.opt_state.inner_state[0]
    stats = _np(jstate.batch_stats)
    moments = [hrnet_from_flax({"params": _np(m), "batch_stats": stats},
                               HRNetCfg.tiny()) for m in (adam.mu, adam.nu)]
    state = create_train_state(get_model("hrnet_tiny"), device="cpu")
    optim = payload["optimizer"]["state"]
    for i, (name, _) in enumerate(state.model.named_parameters()):
        assert float(optim[i]["step"]) == float(adam.count) == 2.0
        assert torch.equal(optim[i]["exp_avg"], moments[0][name]), name
        assert torch.equal(optim[i]["exp_avg_sq"], moments[1][name]), name
        assert float(moments[1][name].abs().max()) > 0, name


@pytest.fixture(scope="module")
def armo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("armo"))
    torch_fixtures.write_armo_tree(root, 10)
    return root


def test_converted_run_evaluates_as_jax(run, armo_root, monkeypatch):
    jdir, pdir, _, _, _ = run
    argv = ["--root", "hrnet/ours", "--name", "x", "--root_path", "runs",
            "--eval", "--dataset-root", armo_root, "--batch_size", "8",
            "--num-workers", "2"]
    monkeypatch.chdir(jdir)
    assert jax_cli.main(argv) == 0
    monkeypatch.chdir(pdir)
    assert cli.main(argv + ["--platform", "cpu"]) == 0
    rel = os.path.join("output", "hrnet", "ours", "x", "evaluation.json")
    with open(pdir / rel) as f, open(jdir / rel) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert sum(len(c["gt"]) for c in got[0].values()) == 10
    files = sorted(f for f in os.listdir(jdir) if f.startswith("pck_eval_"))
    assert len(files) == 3
    for name in files:
        assert (open(pdir / name).read().splitlines()
                == open(jdir / name).read().splitlines())


def test_resumed_step_equals_jax_resumed_step(run):
    _, _, jrun, prun, _ = run
    template = jax_create_state(
        jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision()),
        jax.random.PRNGKey(9), input_shape=(1, 32, 32, 3), lr=1.0)
    best, start, jstate, count = jax_resume(template, jrun)
    state = create_train_state(
        get_model("hrnet_tiny", policy=DTypePolicy.full_precision()),
        torch.Generator().manual_seed(9), lr=1.0, device="cpu")
    pbest, pstart, state, pcount = resume_checkpoint(state, prun)
    assert (pbest, pstart, pcount, state.step) == (best, start, count,
                                                    int(jstate.step))
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(LR)

    batch = _batch(5)
    jstate, jm = _jax_step()(jstate, jax.random.PRNGKey(5),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    state, pm = make_fused_train_step(
        heatmap_size=16, compute_dtype=torch.float32, device="cpu")(
        state, torch.Generator(), {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert state.step == int(jstate.step) == 3

    want = hrnet_from_flax(_np({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}),
                           HRNetCfg.tiny())
    adam = jstate.opt_state.inner_state[0]
    stats = _np(jstate.batch_stats)
    mu = hrnet_from_flax({"params": _np(adam.mu), "batch_stats": stats},
                         HRNetCfg.tiny())
    nu = hrnet_from_flax({"params": _np(adam.nu), "batch_stats": stats},
                         HRNetCfg.tiny())
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2 * LR * (1 + 1e-3),
                                   err_msg=name)
        s = state.optimizer.state[p]
        assert float(s["step"]) == float(adam.count) == 3.0
        for got, ref in ((s["exp_avg"], mu[name]), (s["exp_avg_sq"],
                                                     nu[name])):
            scale = float(ref.abs().max()) or 1.0
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=MOMENT_RTOL * scale,
                                       err_msg=name)


def test_converter_raises_on_another_architecture(run, tmp_path):
    _, _, jrun, _, _ = run
    conv = _converter()
    with pytest.raises(ValueError, match="does not hold a 'resnet18'"):
        conv.convert(jrun, str(tmp_path / "a"), model="resnet18")
    with pytest.raises(ValueError, match="does not hold a 'hrnet_w32'"):
        conv.convert(jrun, str(tmp_path / "b"), model="hrnet_w32")
    assert not os.path.exists(tmp_path / "a" / "checkpoint-good")
    bare = tmp_path / "bare"
    bare.mkdir()
    with pytest.raises(ValueError, match="--model"):
        conv.convert(str(bare), str(tmp_path / "c"))
    with pytest.raises(FileNotFoundError):
        conv.convert(str(bare), str(tmp_path / "c"), model="hrnet_tiny")
