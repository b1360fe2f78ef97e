"""The port's train/eval/predict steps against the JAX package's, and the
port's package rules (device, imports).

Both frameworks start from the same weights (JAX init -> hrnet_from_flax)
and run on the CPU in f32 (hrnet_tiny, 64x64 input, 16x16 heatmaps), where
the port's kernel wrappers take their plain twins.

Train-step tolerances, measured (lr 1e-4, 4 samples, 3 calls):

- loss: the first call agrees to ~5e-7 (scan 1) / 7e-6 (scan 2, a mean
  over two steps), the later ones to 4e-4 / 1.1e-3. One Adam step moves
  each param by about lr * sign(g), so a gradient near zero whose sign the
  two frameworks' summation orders decide moves it by 2 lr instead of 0;
  that noise compounds step by step. The bounds below are those figures
  with a margin of ~5x.
- params: per element within 2 * steps * lr (measured 3.8e-4 of 6e-4 for 3
  steps, 6.2e-4 of 1.2e-3 for 6).
- BatchNorm running stats follow the (noise-divergent) params: measured
  max 1.2e-3 (3 steps) and 1.0e-2 (6 steps).

A semantic slip (targets, normalize, loss scale, optimizer wiring, BN
statistics) moves these by orders of magnitude more; lr 1e-3 would
amplify the sign noise tenfold (1% loss gap by the third step).
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.train import create_train_state as jax_create_state
from lighthand_tpu.train.step import (
    make_eval_step as jax_eval_step,
    make_fused_train_step as jax_fused_step,
    make_predict_step as jax_predict_step,
)
from lighthand_tpu_torch.core.dtypes import DTypePolicy
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.train import step as port_step
from lighthand_tpu_torch.train import (
    cosine_lr,
    create_train_state,
    make_eval_step,
    make_fused_train_step,
    make_predict_step,
    make_targets,
    make_train_step,
    set_learning_rate,
)
from lighthand_tpu_torch.utils.weights import hrnet_from_flax

REPO = pathlib.Path(__file__).resolve().parents[1]
LR = 1e-4
T = torch.from_numpy


def _pair(lr=LR):
    """(JAX TrainState, port TrainState) holding the same hrnet_tiny."""
    jmodel = jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision())
    jstate = jax_create_state(jmodel, jax.random.PRNGKey(0),
                              input_shape=(1, 64, 64, 3), lr=lr)
    port = get_model("hrnet_tiny", policy=DTypePolicy.full_precision())
    port.load_state_dict(hrnet_from_flax(_variables(jstate), HRNetCfg.tiny()))
    return jstate, create_train_state(port, lr=lr, device="cpu")


def _variables(jstate):
    return jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        {"params": jstate.params, "batch_stats": jstate.batch_stats})


# loss rtol per call, param atol, running-stat atol
_TOL = {1: ((1e-5, 2e-3, 2e-3), 2 * 3 * LR, 5e-3),
        2: ((5e-5, 5e-3, 5e-3), 2 * 6 * LR, 3e-2)}


@pytest.mark.parametrize("scan_steps", [1, 2])
def test_fused_train_step_matches_jax(scan_steps):
    jstate, pstate = _pair()
    rng = np.random.default_rng(1)
    lead = (scan_steps,) if scan_steps > 1 else ()
    images = rng.integers(0, 256, size=lead + (4, 64, 64, 3), dtype=np.uint8)
    joints = rng.uniform(8, 56, size=lead + (4, 21, 2)).astype(np.float32)
    off = np.zeros(lead + (4,), np.float32)  # aug and noise off
    jstep = jax_fused_step(heatmap_size=16, stride=4.0, jitter=True,
                           scan_steps=scan_steps, compute_dtype=jnp.float32,
                           use_pallas_aug=False)
    pstep = make_fused_train_step(heatmap_size=16, scan_steps=scan_steps,
                                  compute_dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    loss_rtol, param_atol, stat_atol = _TOL[scan_steps]
    for i, rtol in enumerate(loss_rtol):
        jstate, jm = jstep(jstate, jax.random.PRNGKey(i),
                           {"image_u8": jnp.asarray(images),
                            "joints": jnp.asarray(joints),
                            "aug_enabled": jnp.asarray(off)})
        pstate, pm = pstep(pstate, gen, {"image_u8": T(images),
                                         "joints": T(joints),
                                         "aug_enabled": T(off),
                                         "noise_enabled": T(off)})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=rtol, err_msg=f"call {i}")
    assert pstate.step == 3 * scan_steps

    want = hrnet_from_flax(_variables(jstate), HRNetCfg.tiny())
    got = pstate.model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        stat = k.endswith(("running_mean", "running_var"))
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=0,
            atol=stat_atol if stat else param_atol, err_msg=k)


def test_train_step_is_the_fused_step_without_aug():
    """make_train_step (normalised float images, targets from make_targets)
    is the fused step fed the same pixels with aug and noise off."""
    plain_state, fused_state = (
        create_train_state(get_model("hrnet_tiny", policy=DTypePolicy
                                     .full_precision()),
                           torch.Generator().manual_seed(0), lr=LR,
                           device="cpu") for _ in range(2))
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    joints = T(rng.uniform(8, 56, size=(4, 21, 2)).astype(np.float32))
    from lighthand_tpu_torch.ops.color import normalize_imagenet

    plain = make_train_step(heatmap_size=16, device="cpu")
    fused = make_fused_train_step(heatmap_size=16,
                                  compute_dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        plain_state, pm = plain(plain_state, {
            "image": normalize_imagenet(T(images).float() / 255.0),
            "joints": joints})
        fused_state, fm = fused(fused_state, gen, {
            "image_u8": T(images), "joints": joints,
            "aug_enabled": torch.zeros(4)})
        assert float(pm["loss"]) == float(fm["loss"])


def _eval_batch(cols):
    rng = np.random.default_rng(3 + cols)
    joints = rng.uniform(8, 56, size=(6, 21, cols)).astype(np.float32)
    if cols == 3:
        joints[..., 2] = rng.integers(0, 2, size=(6, 21))
    return {"image": rng.normal(size=(6, 64, 64, 3)).astype(np.float32),
            "joints": joints,
            "valid": np.array([1, 1, 1, 1, 0, 0], np.float32)}


def _jax_state_returning(jstate, pred_nchw):
    """The JAX state with its model replaced by the port's heatmaps, so the
    decode and metrics compare exactly; the forward itself is held to the
    JAX forward in tests/test_torch_models.py. (A random-init net has
    near-tied maxima: a last-ulp forward difference could move an argmax.)"""
    pred = jnp.asarray(np.transpose(pred_nchw, (0, 2, 3, 1)))
    return jstate.replace(apply_fn=lambda variables, x, train=False: pred)


def _port_pred(pstate, images):
    pstate.model.eval()
    with torch.no_grad():
        return pstate.model(T(images).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("cols", [2, 3])
def test_eval_step_matches_jax(cols):
    jstate, pstate = _pair()
    batch = _eval_batch(cols)
    got = make_eval_step(heatmap_size=16, device="cpu")(
        pstate, {k: T(v) for k, v in batch.items()})
    pred = _port_pred(pstate, batch["image"])
    want = jax_eval_step(heatmap_size=16, stride=4.0)(
        _jax_state_returning(jstate, pred),
        {k: jnp.asarray(v) for k, v in batch.items()})

    assert set(got) == set(want)
    np.testing.assert_array_equal(got["pred_joints"].numpy(),
                                  np.asarray(want["pred_joints"]))
    assert float(got["n_valid"]) == 4.0
    for k in ("pck_sum", "pck_count", "epe_count", "n_valid"):
        assert float(got[k]) == float(want[k]), k
    for k in ("loss", "loss_sum", "pck", "epe_sum"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_predict_step_matches_jax():
    jstate, pstate = _pair()
    images = _eval_batch(2)["image"]
    got_j, got_v = make_predict_step(device="cpu")(pstate, T(images))
    want_j, want_v = jax_predict_step(stride=4.0)(
        _jax_state_returning(jstate, _port_pred(pstate, images)),
        jnp.asarray(images))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ----------------------------------------------------------- package rules


@pytest.mark.parametrize("entry", [
    lambda: create_train_state(get_model("hrnet_tiny")),
    make_fused_train_step, make_train_step, make_eval_step,
    make_predict_step,
], ids=["create_train_state", "make_fused_train_step", "make_train_step",
        "make_eval_step", "make_predict_step"])
def test_entry_point_without_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _port_files():
    return sorted((REPO / "lighthand_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "kernel_breakdown.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "lighthand_tpu", "cv2",
                                    "PIL"), (path, name)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "lighthand_tpu_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    for new in ("cli.make_synth_data", "cli.make_lighthand",
                "utils.visualize", "ops.geometry", "ops.procrustes",
                "utils.landmarks", "utils.vis3d", "utils.mesh_render",
                "ops.kernels.rasterize"):
        assert f"lighthand_tpu_torch.{new}" in mods
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import importlib\n"
            f"for m in {mods!r} + ['chip_smoke', 'kernel_breakdown']: "
            "importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lighthand_tpu', 'cv2', 'PIL', 'orbax')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_tree_making_clis_run_without_jax_or_cv2(tmp_path):
    """The two tree-making CLIs and an overlay, run to the end in a fresh
    process (their imports inside functions included), load no jax, JAX
    package, cv2 or PIL."""
    import torch_fixtures

    raw = tmp_path / "raw"
    phase = torch_fixtures.write_armhand_tree(str(raw), n=2)
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "from lighthand_tpu_torch.cli import make_lighthand, make_synth_data\n"
        "from lighthand_tpu_torch.utils.visualize import save_overlay\n"
        "out = sys.argv[2]\n"
        "assert make_synth_data.main(['--out', out + '/s', '--n-train', '1',"
        " '--n-eval', '1', '--n-armo', '1', '--n-frei', '2']) == 0\n"
        "assert make_lighthand.main(['--root', sys.argv[3], '--out', out +"
        f" '/l', '--phase', '{phase}']) == 0\n"
        "save_overlay(np.zeros((8, 8, 3), np.float32), np.ones((21, 2)),"
        " None, out, 'train', 0, 0)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'lighthand_tpu', 'cv2', 'PIL', 'orbax')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO),
                          str(tmp_path), str(raw)], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "train_image" / "0_epoch" / "iter_0.jpg").is_file()


def test_port_imports_matplotlib_only_in_the_two_figure_functions():
    """As the JAX package does: ``plot_landmarks`` and ``vis_3d_keypoints``
    import matplotlib when called; nothing else of the port imports it."""
    where = []
    for path in _port_files():
        tree = ast.parse(path.read_text())
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)] + [tree]:
            body = fn.body if fn is not tree else [
                n for n in tree.body if not isinstance(n, ast.FunctionDef)]
            for node in (m for b in body for m in ast.walk(b)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module] if isinstance(node, ast.ImportFrom)
                         and node.module else [])
                if any(n.split(".")[0] == "matplotlib" for n in names):
                    where.append((path.name, getattr(fn, "name", None)))
    assert sorted(set(where)) == [("landmarks.py", "plot_landmarks"),
                                  ("vis3d.py", "vis_3d_keypoints")]


def test_overlays_and_renderer_run_without_jax_cv2_or_matplotlib(tmp_path):
    """The landmark, axis and skeleton overlays (written as JPEG and PNG)
    and a CPU render, run in a fresh process, load no jax, JAX package,
    cv2, PIL or matplotlib."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "import numpy as np\n"
        "from lighthand_tpu_torch.utils import landmarks, mesh_render, "
        "vis3d\n"
        "img = np.zeros((32, 32, 3), np.uint8)\n"
        "rng = np.random.default_rng(0)\n"
        "landmarks.draw_landmarks(img, rng.uniform(0, 1, (21, 4)), "
        "landmarks.HAND_CONNECTIONS)\n"
        "landmarks.draw_axis(img, np.eye(3), np.array([0, 0, -0.5]))\n"
        "sk = vis3d.hand_skeleton_21()\n"
        "for ext in ('jpg', 'png'):\n"
        "    vis3d.vis_keypoints(img, rng.uniform(0, 32, (21, 2)), "
        "np.ones(21), sk, filename=sys.argv[2] + '/kp.' + ext)\n"
        "v = np.array([[-1, -1, 5], [1, -1, 5], [1, 1, 5.0]])\n"
        "mesh_render.Renderer(16, 16, faces=np.array([[0, 2, 1]]), "
        "device='cpu').render(v, focal_length=8.0)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'lighthand_tpu', 'cv2', 'PIL', 'orbax', 'matplotlib')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(REPO),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (tmp_path / "kp.jpg").is_file() and (tmp_path / "kp.png").is_file()


@pytest.mark.parametrize("style,exc", [("max", None), ("per_sample", None),
                                       ("gaussian", ValueError)])
def test_unported_target_styles_raise(style, exc):
    """Only an unknown style raises: "max" and "per_sample" are ported."""
    calls = (lambda: make_targets(torch.zeros(1, 21, 2), style=style,
                                  hm_max=torch.ones(1)),
             lambda: make_eval_step(target_style=style, device="cpu"),
             lambda: make_fused_train_step(target_style=style, device="cpu"))
    for call in calls:
        if exc is None:
            call()
        else:
            with pytest.raises(exc):
                call()


@pytest.mark.parametrize("hm,stride,njoints", [(64, 4.0, 21), (16, 4.0, 21),
                                               (50, 3.0, 21), (32, 2.0, 14)])
@pytest.mark.parametrize("style", ["max", "per_sample", "msra"])
def test_make_targets_styles_match_jax(style, hm, stride, njoints):
    """Max-combine maps (sigma = hm/64, truncated centers, |d| <= 3s+1, a
    joint only when x > 0 and in bounds) and the per-sample select, with
    joints on and off the map edges, within 1e-6."""
    from lighthand_tpu.train.step import make_targets as jax_make_targets

    rng = np.random.default_rng(hm + njoints)
    joints = rng.uniform(-20, hm * stride + 20, size=(6, njoints, 3))
    joints[0, :4, 0] = [0.0, -0.5, 1e-3, hm * stride - 0.01]
    joints = joints.astype(np.float32)
    hm_max = np.array([1, 0, 1, 1, 0, 0], np.float32)
    got = make_targets(T(joints), style=style, heatmap_size=hm, stride=stride,
                       hm_max=T(hm_max))
    want = jax_make_targets(jnp.asarray(joints), style=style,
                            heatmap_size=hm, stride=stride,
                            hm_max=jnp.asarray(hm_max))
    assert tuple(got.shape) == want.shape == (6, njoints, hm, hm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if style == "max" and njoints == 21:  # the one-sample form
        from lighthand_tpu.ops.heatmap import generate_heatmap_max as jax_one

        from lighthand_tpu_torch.ops.heatmap import generate_heatmap_max

        np.testing.assert_allclose(
            generate_heatmap_max(T(joints[0] / stride), hm).numpy(),
            np.asarray(jax_one(jnp.asarray(joints[0] / stride), hm)),
            rtol=0, atol=1e-6)


def test_per_sample_needs_hm_max():
    with pytest.raises(ValueError, match="hm_max"):
        make_targets(torch.zeros(1, 21, 2), style="per_sample")


@pytest.mark.parametrize("style", ["per_sample", "max"])
def test_fused_train_step_max_styles_match_jax(style):
    """The fused step with max-combine targets (K1's image, targets
    replaced where hm_max is set) against the JAX package's jnp chain, one
    step each. Jitter and noise are off, so neither side draws anything
    that reaches the image (the injected draws are the identity)."""
    jstate, pstate = _pair()
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, size=(4, 64, 64, 3), dtype=np.uint8)
    joints = rng.uniform(4, 60, size=(4, 21, 2)).astype(np.float32)
    off = np.zeros(4, np.float32)
    hm_max = np.array([1, 0, 0, 1], np.float32)
    jstep = jax_fused_step(heatmap_size=16, stride=4.0, jitter=True,
                           target_style=style, compute_dtype=jnp.float32,
                           use_pallas_aug=False)
    pstep = make_fused_train_step(heatmap_size=16, target_style=style,
                                  compute_dtype=torch.float32, device="cpu")
    jstate, jm = jstep(jstate, jax.random.PRNGKey(0),
                       {"image_u8": jnp.asarray(images),
                        "joints": jnp.asarray(joints),
                        "aug_enabled": jnp.asarray(off),
                        "noise_enabled": jnp.asarray(off),
                        "hm_max": jnp.asarray(hm_max)})
    pstate, pm = pstep(pstate, torch.Generator().manual_seed(0),
                       {"image_u8": T(images), "joints": T(joints),
                        "aug_enabled": T(off), "noise_enabled": T(off),
                        "hm_max": T(hm_max)})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = hrnet_from_flax(_variables(jstate), HRNetCfg.tiny())
    got = pstate.model.state_dict()
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean",
                       "running_var")):
            continue
        # one Adam step moves a param by about lr * sign(g): a sign the
        # two summation orders decide differently is 2 lr apart
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * LR * (1 + 1e-3), err_msg=k)


def test_eval_step_per_sample_matches_jax():
    jstate, pstate = _pair()
    rng = np.random.default_rng(6)
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    joints = rng.uniform(4, 60, size=(4, 21, 2)).astype(np.float32)
    hm_max = np.array([0, 1, 1, 0], np.float32)
    jm = jax_eval_step(heatmap_size=16, target_style="per_sample")(
        jstate, {"image": jnp.asarray(images), "joints": jnp.asarray(joints),
                 "hm_max": jnp.asarray(hm_max)})
    pm = make_eval_step(heatmap_size=16, target_style="per_sample",
                        device="cpu")(pstate, {"image": T(images),
                                               "joints": T(joints),
                                               "hm_max": T(hm_max)})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)


# ----------------------------------------- the flip / rotation chain route


def _jax_draws(key, aug, noise, flip=False, rot=0.0):
    """What JAX's chain draws from ``key`` (``lighthand_tpu/train/step.py:
    171-216``, ``ops/color.py``), as the port's packed [B, 12] params, the
    flip mask and the degrees."""
    from lighthand_tpu.ops.color import channel_pixel_noise

    b = aug.shape[0]
    k_pre, k_flip, k_rot = jax.random.split(key, 3)
    k_jit, k_noise = jax.random.split(k_pre)
    params = np.zeros((b, 12), np.float32)
    params[:, 0] = aug
    for i, k in enumerate(jax.random.split(k_jit, b)):
        k_order, kb, kc, ks, kh = jax.random.split(k, 5)
        params[i, 1:5] = [jax.random.uniform(kk, (), minval=lo, maxval=hi)
                          for kk, lo, hi in ((kb, 0.5, 1.5), (kc, 0.5, 1.5),
                                             (ks, 0.5, 1.5),
                                             (kh, -0.5, 0.5))]
        params[i, 5:9] = np.asarray(jax.random.permutation(k_order, 4))
    for i, k in enumerate(jax.random.split(k_noise, b)):
        pn = np.asarray(jax.random.uniform(k, (3,), minval=0.6, maxval=1.4))
        params[i, 9:12] = pn * noise[i] + (1.0 - noise[i])
        # the same factor is what JAX's channel_pixel_noise applies
        assert np.allclose(np.asarray(channel_pixel_noise(
            k, jnp.ones((1, 1, 3)) * 0.5, enable=noise[i]))[0, 0],
            np.clip(0.5 * params[i, 9:12], 0, 1), atol=1e-7)
    mask = (np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
            if flip else None)
    deg = (np.array(jax.random.uniform(k_rot, (b,), minval=-rot,
                                         maxval=rot)) if rot > 0 else None)
    return params, mask, deg


def _jax_chain(key, images_u8, joints, aug, noise, flip, rot):
    """JAX's functions composed in ``_one``'s order (``lighthand_tpu/train/
    step.py:216-224``): (images f32, moved joints)."""
    from lighthand_tpu.ops import affine as jaff
    from lighthand_tpu.ops.color import (
        channel_pixel_noise,
        color_jitter,
        normalize_imagenet,
    )

    b = images_u8.shape[0]
    k_pre, k_flip, k_rot = jax.random.split(key, 3)
    k_jit, k_noise = jax.random.split(k_pre)
    imgs = jnp.asarray(images_u8).astype(jnp.float32) / 255.0
    imgs = jax.vmap(color_jitter)(jax.random.split(k_jit, b), imgs,
                                  enable=jnp.asarray(aug))
    imgs = jax.vmap(lambda k, im, en: channel_pixel_noise(k, im, enable=en))(
        jax.random.split(k_noise, b), imgs, jnp.asarray(noise))
    j = jnp.asarray(joints)
    if rot > 0:
        deg = jax.random.uniform(k_rot, (b,), minval=-rot, maxval=rot)
        imgs, j = jaff.rotate_px_batch(imgs, j, deg)
    images = normalize_imagenet(imgs).astype(jnp.float32)
    if flip:
        images, j = jaff.hflip_px(images, j, jax.random.bernoulli(
            k_flip, 0.5, (b,)))
    return np.array(images), np.array(j)


# the chain's images against JAX's (ImageNet-normalised units): jitter
# agrees to 1e-5 and a warp to 5e-5 on [0, 1] values (tests/
# test_torch_ops.py, tests/test_torch_affine.py), / std 0.225; measured
# 5.0e-6 (the hue's f32 arithmetic), the joints equal
CHAIN_IMAGE_ATOL = 3e-4
CHAIN_JOINT_ATOL = 1e-4
AFFINE_CASES = [{"flip": True}, {"rot_deg": 15.0},
                {"flip": True, "rot_deg": 15.0}]


def _chain_batch(seed, b=6, cols=2):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(b, 64, 64, 3), dtype=np.uint8)
    joints = rng.uniform(6, 58, size=(b, 21, cols)).astype(np.float32)
    if cols == 3:
        joints[..., 2] = rng.integers(0, 2, size=(b, 21))
    aug = (np.arange(b) % 2).astype(np.float32)
    noise = (np.arange(b) % 3 == 1).astype(np.float32)
    return images, joints, aug, noise


@pytest.mark.parametrize("kw", AFFINE_CASES + [{}],
                         ids=["flip", "rot", "flip_rot", "neither"])
@pytest.mark.parametrize("cols", [2, 3])
def test_chain_matches_jax_with_its_draws(kw, cols):
    """jitter -> noise -> rotate -> normalize -> flip -> targets against
    JAX's functions composed in ``_one``'s order, the draws replayed from
    JAX's key. The targets are compared from JAX's moved joints: MSRA's
    truncated centre flips on a 1e-4 px joint difference at a pixel
    boundary."""
    from lighthand_tpu.train.step import make_targets as jax_make_targets

    flip, rot = kw.get("flip", False), kw.get("rot_deg", 0.0)
    images, joints, aug, noise = _chain_batch(10 + cols, cols=cols)
    key = jax.random.PRNGKey(7)
    params, mask, deg = _jax_draws(key, aug, noise, flip, rot)
    got_i, got_j = port_step.chain_augment(
        T(images), T(joints), T(params),
        None if mask is None else T(mask), None if deg is None else T(deg),
        out_dtype=torch.float32)
    want_i, want_j = _jax_chain(key, images, joints, aug, noise, flip, rot)
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0,
                               atol=CHAIN_IMAGE_ATOL)
    np.testing.assert_allclose(got_j.numpy(), want_j, rtol=0,
                               atol=CHAIN_JOINT_ATOL)
    np.testing.assert_allclose(
        make_targets(T(want_j), heatmap_size=16).numpy(),
        np.asarray(jax_make_targets(jnp.asarray(want_j), heatmap_size=16)),
        rtol=0, atol=1e-6)


def test_chain_without_flip_or_rotation_is_k1():
    """With neither flag the chain is K1's function: on the same packed
    draws it gives K1's plain twin's image and targets, bit for bit."""
    from lighthand_tpu_torch.ops.kernels.fused_aug import (
        draw_aug_params,
        fused_aug_targets_plain,
    )

    images, joints, aug, noise = _chain_batch(3)
    params = draw_aug_params(torch.Generator().manual_seed(0), T(aug),
                             T(noise))
    for dtype in (torch.float32, torch.bfloat16):
        got_i, got_j = port_step.chain_augment(T(images), T(joints), params,
                                               out_dtype=dtype)
        want_i, want_t = fused_aug_targets_plain(T(images), T(joints),
                                                 params, heatmap_size=16,
                                                 out_dtype=dtype)
        assert torch.equal(got_i, want_i) and torch.equal(got_j, T(joints))
        assert torch.equal(make_targets(got_j, heatmap_size=16), want_t)


def test_draw_affine_params_order_and_ranges():
    """The mask (Bernoulli 0.5) first, then the degrees in [-rot, rot]; a
    draw that is off consumes nothing from the generator."""
    gen = torch.Generator().manual_seed(3)
    mask, deg = port_step.draw_affine_params(gen, 4000, True, 15.0)
    assert mask.dtype == torch.bool and 0.45 < mask.float().mean() < 0.55
    assert deg.abs().max() <= 15.0 and deg.min() < -14 and deg.max() > 14
    again = torch.Generator().manual_seed(3)
    assert torch.equal(port_step.draw_affine_params(again, 4000, True)[0],
                       mask)
    rot_only = port_step.draw_affine_params(torch.Generator().manual_seed(3),
                                            4000, False, 15.0)
    assert rot_only[0] is None
    assert torch.equal(rot_only[1], -15.0 + 30.0 * torch.rand(
        4000, generator=torch.Generator().manual_seed(3)))
    state = torch.Generator().manual_seed(3)
    assert port_step.draw_affine_params(state, 8) == (None, None)
    assert torch.equal(state.get_state(),
                       torch.Generator().manual_seed(3).get_state())


@pytest.mark.parametrize("kw", AFFINE_CASES, ids=["kw0", "kw1", "kw2"])
def test_unported_affine_augmentations_raise(kw, monkeypatch):
    """Once a raise (the flags were not ported); now the working route: a
    whole ``flip`` / ``rot_deg`` step against JAX's step with
    ``use_pallas_aug=False``, the port given JAX's draws, under the step
    tolerances of ``test_fused_train_step_max_styles_match_jax``."""
    jstate, pstate = _pair()
    flip, rot = kw.get("flip", False), kw.get("rot_deg", 0.0)
    images, joints, aug, noise = _chain_batch(20, b=4)
    key = jax.random.PRNGKey(3)
    params, mask, deg = _jax_draws(key, aug, noise, flip, rot)
    monkeypatch.setattr(port_step, "draw_aug_params",
                        lambda gen, a, n: T(params))
    monkeypatch.setattr(port_step, "draw_affine_params", lambda gen, b, f, r: (
        None if mask is None else T(mask), None if deg is None else T(deg)))
    jstep = jax_fused_step(heatmap_size=16, stride=4.0, jitter=True,
                           compute_dtype=jnp.float32, use_pallas_aug=False,
                           **kw)
    pstep = make_fused_train_step(heatmap_size=16, compute_dtype=torch.float32,
                                  device="cpu", **kw)
    batch = {"image_u8": images, "joints": joints, "aug_enabled": aug,
             "noise_enabled": noise}
    jstate, jm = jstep(jstate, key, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    pstate, pm = pstep(pstate, torch.Generator(),
                       {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    want = hrnet_from_flax(_variables(jstate), HRNetCfg.tiny())
    got = pstate.model.state_dict()
    for k, w in want.items():
        if k.endswith(("num_batches_tracked", "running_mean",
                       "running_var")):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=2 * LR * (1 + 1e-3), err_msg=k)


@pytest.mark.parametrize("kw,k1,k2", [({}, 2, 0), ({"flip": True}, 0, 2),
                                      ({"rot_deg": 10.0}, 0, 2)],
                         ids=["neither", "flip", "rot"])
def test_fused_step_route_by_flags(kw, k1, k2, monkeypatch, caplog):
    """Neither flag: K1 once a step, as before. ``flip`` or ``rot_deg``:
    K2 for the targets and no K1, logged once when the step is built."""
    calls = {"k1": 0, "k2": 0}

    def count(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port_step, "fused_aug_targets_cuda", count(
        "k1", port_step.fused_aug_targets_cuda))
    monkeypatch.setattr(port_step, "generate_target_batch_cuda", count(
        "k2", port_step.generate_target_batch_cuda))
    _, pstate = _pair()
    images, joints, aug, noise = _chain_batch(4, b=2)
    with caplog.at_level("WARNING", logger="lighthand_tpu_torch"):
        step = make_fused_train_step(heatmap_size=16, device="cpu", **kw)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        pstate, m = step(pstate, gen, {"image_u8": T(images),
                                       "joints": T(joints),
                                       "aug_enabled": T(aug)})
        assert np.isfinite(float(m["loss"]))
    assert calls == {"k1": k1, "k2": k2}
    routed = [r for r in caplog.records if "K1" in r.getMessage()]
    assert len(routed) == (1 if kw else 0)


def test_fused_step_checks_scan_leading_dim():
    _, pstate = _pair()
    step = make_fused_train_step(heatmap_size=16, scan_steps=2, device="cpu")
    batch = {"image_u8": torch.zeros(3, 2, 64, 64, 3, dtype=torch.uint8),
             "joints": torch.zeros(3, 2, 21, 2),
             "aug_enabled": torch.zeros(3, 2)}
    with pytest.raises(ValueError, match="scan_steps"):
        step(pstate, torch.Generator(), batch)


def test_cosine_lr_and_set_learning_rate():
    assert cosine_lr(1e-3, 0, 100) == 1e-3
    assert abs(cosine_lr(1e-3, 100, 100)) < 1e-12
    assert abs(cosine_lr(1e-3, 50, 100) - 5e-4) < 1e-12
    state = create_train_state(get_model("hrnet_tiny"),
                               torch.Generator().manual_seed(0), lr=1e-3,
                               device="cpu")
    set_learning_rate(state, 1e-5)
    assert [g["lr"] for g in state.optimizer.param_groups] == [1e-5]


def test_create_train_state_seeded_init_is_reproducible():
    a = create_train_state(get_model("hrnet_tiny"),
                           torch.Generator().manual_seed(4), device="cpu")
    b = create_train_state(get_model("hrnet_tiny"),
                           torch.Generator().manual_seed(4), device="cpu")
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    w = a.model.conv2.weight  # torch default init: U(+-1/sqrt(fan_in))
    assert w.abs().max() <= 1 / np.sqrt(64 * 9) and w.std() > 0
