"""The port's offline eval harness and CLI (``lighthand_tpu_torch.eval``,
``lighthand_tpu_torch.cli.eval``) against the JAX package's, on the CPU.

The harness's arithmetic is numpy in both packages, so the curves, AUCs,
EPEs and stores are held equal value for value. The CLIs are run end to
end on one Armo tree of the fixture JPEGs (``torch_fixtures.write_armo_tree``)
with the same hrnet_tiny weights: a JAX orbax checkpoint for the JAX CLI,
a port checkpoint (``utils/weights.py:hrnet_from_flax``) for the port's.
Categories, counts, GT and ``bb`` must be identical. Predictions could
differ at argmax near-ties (ROADMAP.md, Queue 3); measured, every joint is
equal under f32, bf16 and int8_fwd serving and in the ``--test`` flow (the
bf16 image batch is the same in both, and the weights' BN stats are
perturbed so the maps have clear peaks), so the test holds them equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_fixtures
from lighthand_tpu.cli import eval as jax_cli
from lighthand_tpu.core.dtypes import DTypePolicy as JaxPolicy
from lighthand_tpu.data import Loader as JaxLoader
from lighthand_tpu.data.armo import ArmoEvalSet as JaxArmo
from lighthand_tpu.eval import harness as jh
from lighthand_tpu.models import get_model as jax_get_model
from lighthand_tpu.train import create_train_state as jax_create_state
from lighthand_tpu.train.checkpoint import save_checkpoint as jax_save
from lighthand_tpu_torch.cli import eval as cli
from lighthand_tpu_torch.data import Loader, preprocess_u8
from lighthand_tpu_torch.data.armo import POSE_CATEGORIES, ArmoEvalSet
from lighthand_tpu_torch.eval import harness as h
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.models.hrnet import HRNetCfg
from lighthand_tpu_torch.train import create_train_state
from lighthand_tpu_torch.train.checkpoint import save_checkpoint
from lighthand_tpu_torch.utils.weights import hrnet_from_flax

REGIMES = [("pckb", [0.1, 0.3]), ("mm", [0, 30]), ("mm", [0, 50])]
REGIME_IDS = ["pckb0.3", "mm30", "mm50"]
N_ARMO = 10  # + 2 incomplete records, dropped


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    torch's default of one thread per core oversubscribes the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _fake_store(rng, n_per_cat=25, empty=()):
    meta = {}
    for c in POSE_CATEGORIES:
        n = 0 if c in empty else n_per_cat
        gt_xy = rng.uniform(30, 220, size=(n, 21, 2))
        vis = (rng.uniform(size=(n, 21, 1)) > 0.2).astype(float)
        gt = np.concatenate([gt_xy, vis], axis=-1)
        pred = gt_xy + rng.normal(scale=6.0, size=gt_xy.shape)
        bb = [float(np.hypot(*(g.max(0) - g.min(0)))) for g in gt_xy]
        meta[c] = {"bb": bb, "pred": pred.tolist(), "gt": gt.tolist()}
    return meta


# ------------------------------------------------------------ the math


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
def test_threshold_grids_match_jax(regime):
    method, t_list = regime
    got = h._threshold_grid(t_list, method)
    np.testing.assert_array_equal(got, jh._threshold_grid(t_list, method))
    assert len(got) == 100
    want = (np.linspace(t_list[0], t_list[1], 101)[1:] * 2.83464567
            if method == "mm" else np.linspace(t_list[0], t_list[1], 100))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        h._threshold_grid(t_list, "px")


def test_dump_keeps_the_reference_layout(tmp_path):
    path = str(tmp_path / "a" / "evaluation.json")
    h.dump(path, {"x": 1})
    with open(path) as f:
        assert json.load(f) == [{"x": 1}]


@pytest.mark.parametrize("empty", [(), ("Occlusion_by_Both",)],
                         ids=["full", "empty_category"])
@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
def test_pred_eval_matches_jax(tmp_path, regime, compat, empty):
    method, t_list = regime
    path = str(tmp_path / "evaluation.json")
    h.dump(path, _fake_store(np.random.default_rng(len(empty)), 12, empty))
    got = h.pred_eval(path, t_list, method, compat_mean_epe=compat)
    want = jh.pred_eval(path, t_list, method, compat_mean_epe=compat)
    assert got == want
    assert sorted(got) == sorted(
        [c for c in POSE_CATEGORIES if c not in empty] + ["mean_auc"])
    # EPE in mm is px / 3.7795275591; compat pads the mean with 971 zeros
    rec = json.load(open(path))[0]["Standard"]
    diff = np.linalg.norm(np.asarray(rec["gt"])[..., :2]
                          - np.asarray(rec["pred"]), axis=-1)
    assert got["Standard"][1] == float(diff.mean() / 3.7795275591)
    fixed = h.pred_eval(path, t_list, method, compat_mean_epe=False)
    assert (got["mean_auc"][1] < fixed["mean_auc"][1]) == compat


@pytest.mark.parametrize("regime", REGIMES, ids=REGIME_IDS)
def test_pred_test_matches_jax(tmp_path, regime):
    rng = np.random.default_rng(3)
    gt = rng.uniform(30, 220, size=(3, 8, 21, 2))
    pred = gt + rng.normal(scale=4.0, size=gt.shape)
    path = str(tmp_path / "test.json")
    h.dump(path, {"pred": [p.tolist() for p in pred],
                  "gt": [g.tolist() for g in gt],
                  "bb": [rng.uniform(80, 120, 8).tolist() for _ in range(3)]})
    got = h.pred_test(path, regime[1], regime[0])
    assert got == jh.pred_test(path, regime[1], regime[0])
    assert got[1] == float(np.sqrt(((gt - pred) ** 2).sum(-1)).mean())
    with pytest.raises(ValueError):
        h.pred_test(path, regime[1], "px")


# ------------------------------------------------------- the stores


@pytest.fixture(scope="module")
def armo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("armo"))
    torch_fixtures.write_armo_tree(root, N_ARMO)
    return root


def _predictions(n_batches, bsz, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 256, (bsz, 21, 2)).astype(np.float32)
            for _ in range(n_batches)]


def _both_loaders(root, bsz=4):
    return (Loader(ArmoEvalSet(root), bsz, device="cpu", drop_last=False,
                   num_workers=2),
            JaxLoader(JaxArmo(root), bsz, mesh=None, drop_last=False,
                      num_workers=2))


@pytest.mark.parametrize("flat", [False, True], ids=["store", "store_test"])
def test_pred_store_matches_jax(tmp_path, armo_root, flat):
    """The same predictions through the port's Loader and store and
    through JAX's give the same JSON; padding rows are dropped."""
    loader, jloader = _both_loaders(armo_root)
    preds = _predictions(len(loader), 4)
    seen = []

    def fake(kind):
        it = iter(preds)

        def predict(images):
            seen.append((kind, tuple(images.shape)))
            out = next(it)
            return torch.from_numpy(out) if kind == "port" else out
        return predict

    store = h.pred_store_test if flat else h.pred_store
    jstore = jh.pred_store_test if flat else jh.pred_store
    got = store(loader, fake("port"), str(tmp_path / "p" / "s.json"))
    want = jstore(jloader, fake("jax"), str(tmp_path / "j" / "s.json"))
    assert got == want
    with open(tmp_path / "p" / "s.json") as f, \
            open(tmp_path / "j" / "s.json") as g:
        assert json.load(f) == json.load(g)
    assert [s for k, s in seen if k == "port"] == [(4, 256, 256, 3)] * 3
    if flat:
        assert np.asarray(got["gt"][0]).shape == (N_ARMO, 21, 2)
    else:
        counts = {c: len(got[c]["gt"]) for c in POSE_CATEGORIES}
        assert counts == {c: len(range(i, N_ARMO, 4))
                          for i, c in enumerate(POSE_CATEGORIES)}


def test_pred_store_preprocess_and_plt(tmp_path, armo_root):
    """``preprocess`` maps the u8 batch before predict_fn; an overlay
    directory (--plt) gets one overlay per valid row, numbered in order
    (the padding rows of the last batch are skipped)."""
    loader, _ = _both_loaders(armo_root)
    got = []
    h.pred_store_test(loader, lambda im: got.append(im.dtype)
                      or torch.zeros(4, 21, 2),
                      str(tmp_path / "t.json"),
                      preprocess=lambda u8: preprocess_u8(u8))
    assert got == [torch.bfloat16] * 3
    store = h.pred_store(loader, lambda im: torch.zeros(4, 21, 2),
                         str(tmp_path / "e.json"), preprocess=preprocess_u8,
                         overlay_dir=str(tmp_path))
    assert sum(len(v["gt"]) for v in store.values()) == N_ARMO
    assert sorted(os.listdir(tmp_path / "eval_image" / "0_epoch")) == sorted(
        f"iter_{i}.jpg" for i in range(N_ARMO))


def test_pred_store_overlay_max(tmp_path):
    """tests/test_overlay_cap.py on the port: --plt_max caps the overlay
    files at 3 while the store still holds every sample."""
    import glob

    from lighthand_tpu_torch.data import SyntheticHands

    bs, n = 8, 24
    src = SyntheticHands(length=n, size=32, seed=77, with_visibility=True)
    loader = Loader(src, bs, device="cpu", shuffle=False, num_workers=2,
                    drop_last=False)
    ov = str(tmp_path / "ov")
    store = h.pred_store(loader, lambda im: torch.zeros(im.shape[0], 21, 2),
                         str(tmp_path / "evaluation.json"), overlay_dir=ov,
                         overlay_max=3)
    jpgs = glob.glob(os.path.join(ov, "eval_image", "*", "*.jpg"))
    assert len(jpgs) == 3
    assert sum(len(v["pred"]) for v in store.values()) == n


def test_pred_store_overlay_bytes_match_jax(tmp_path, armo_root):
    """With the same fixed predictions (some joints off the image) and
    each package's eval preprocess, the port's --plt overlays are JAX's
    ``pred_store``'s, byte for byte."""
    from lighthand_tpu.data import DevicePreprocessor

    loader, jloader = _both_loaders(armo_root)
    preds = [p * 1.1 - 10 for p in _predictions(len(loader), 4, seed=8)]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    it = iter(preds)
    h.pred_store(loader, lambda im: torch.from_numpy(next(it)),
                 str(tmp_path / "p.json"), preprocess=preprocess_u8,
                 overlay_dir=str(port_dir), overlay_max=7)
    it = iter(preds)
    jh.pred_store(jloader, lambda im: next(it), str(tmp_path / "j.json"),
                  preprocess=DevicePreprocessor(jitter=False),
                  rng_key=jax.random.PRNGKey(0), overlay_dir=str(jax_dir),
                  overlay_max=7)
    sub = os.path.join("eval_image", "0_epoch")
    names = sorted(os.listdir(port_dir / sub))
    assert names == sorted(os.listdir(jax_dir / sub))
    assert len(names) == 7
    for name in names:
        assert (port_dir / sub / name).read_bytes() == (
            jax_dir / sub / name).read_bytes(), name


# --------------------------------------------------------- the CLIs


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def trees(tmp_path_factory, armo_root):
    """hrnet_tiny weights (BN stats perturbed, so the maps have clear
    peaks) as a JAX orbax checkpoint and as a port checkpoint, each under
    ``{dir}/runs/hrnet/ours/x``, for each recorded precision."""
    jm = jax_get_model("hrnet_tiny", policy=JaxPolicy.full_precision())
    jstate = jax_create_state(jm, jax.random.PRNGKey(0),
                              input_shape=(1, 32, 32, 3))
    v = _np_tree({"params": jstate.params,
                  "batch_stats": jstate.batch_stats})
    rng = np.random.default_rng(1)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.0, 0.5, a.shape)).astype(np.float32),
        v["batch_stats"])
    jstate = jstate.replace(params=v["params"],
                            batch_stats=v["batch_stats"])
    state = create_train_state(get_model("hrnet_tiny"), device="cpu")
    state.model.load_state_dict(hrnet_from_flax(v, HRNetCfg.tiny()))
    out = {}
    for prec in ("f32", "bf16"):
        jdir = tmp_path_factory.mktemp(f"jax_{prec}")
        pdir = tmp_path_factory.mktemp(f"port_{prec}")
        info = {"name": "hrnet_tiny", "precision": prec}
        jax_save(jstate, str(jdir / "runs" / "hrnet" / "ours" / "x"), 0, 1.0,
                 0, model_info=info)
        save_checkpoint(state, str(pdir / "runs" / "hrnet" / "ours" / "x"),
                        0, 1.0, 0, model_info=info)
        out[prec] = (jdir, pdir)
    return out


def _argv(armo_root, *extra):
    return ["--root", "hrnet/ours", "--name", "x", "--root_path", "runs",
            "--eval", "--dataset-root", armo_root, "--batch_size", "8",
            "--num-workers", "2", *extra]


def _run(main, cwd, argv, monkeypatch):
    monkeypatch.chdir(cwd)
    return main(argv)


@pytest.mark.parametrize("case", ["f32", "bf16", "bf16_test", "int8_fwd"])
def test_eval_cli_matches_jax(trees, armo_root, monkeypatch, case):
    prec = "bf16" if case != "f32" else "f32"
    jdir, pdir = trees[prec]
    extra = {"bf16_test": ["--test"],
             "int8_fwd": ["--precision", "int8_fwd"]}.get(case, [])
    assert _run(jax_cli.main, jdir, _argv(armo_root, *extra),
                monkeypatch) == 0
    assert _run(cli.main, pdir, _argv(armo_root, *extra, "--platform",
                                      "cpu"), monkeypatch) == 0
    if case == "bf16_test":
        got = json.load(open(pdir / "final_model" / "hrnet" / "ours" / "x"
                             / "test.json"))[0]
        want = json.load(open(jdir / "final_model" / "hrnet" / "ours" / "x"
                              / "test.json"))[0]
        assert got["gt"] == want["gt"] and got["bb"] == want["bb"]
        assert np.asarray(got["gt"]).shape == (1, N_ARMO, 21, 2)
        assert got["pred"] == want["pred"]
        return
    got = json.load(open(pdir / "output" / "hrnet" / "ours" / "x"
                         / "evaluation.json"))[0]
    want = json.load(open(jdir / "output" / "hrnet" / "ours" / "x"
                          / "evaluation.json"))[0]
    assert list(got) == list(want) == list(POSE_CATEGORIES)
    for c in POSE_CATEGORIES:
        assert len(got[c]["gt"]) == len(range(POSE_CATEGORIES.index(c),
                                               N_ARMO, 4))
        assert got[c]["gt"] == want[c]["gt"]
        assert got[c]["bb"] == want[c]["bb"]
        assert got[c]["pred"] == want[c]["pred"]
    files = sorted(f for f in os.listdir(pdir) if f.startswith("pck_eval_"))
    assert files == sorted(f for f in os.listdir(jdir)
                           if f.startswith("pck_eval_"))
    assert files == sorted(f"pck_eval_hrnet_ours_x_{m}_{t[1]}.txt"
                           for m, t in REGIMES)
    for name in files:
        rows = open(pdir / name).read().splitlines()
        assert rows == open(jdir / name).read().splitlines()
        assert [r.split(";")[0] for r in rows] == (list(POSE_CATEGORIES)
                                                   + ["mean_auc"])
        assert all(len(r.split(";")) == 4 + 100 + 1 for r in rows)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_eval_cli_f32_runs_without_tf32(trees, armo_root, monkeypatch, prec):
    """An f32 checkpoint predicts with both TF32 switches False (full f32
    on the card); afterwards both are as they were; a bf16 one leaves
    them alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    store = cli.pred_store

    def spy(*args, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return store(*args, **kw)

    monkeypatch.setattr(cli, "pred_store", spy)
    _, pdir = trees[prec]
    assert _run(cli.main, pdir, _argv(armo_root, "--platform", "cpu"),
                monkeypatch) == 0
    inside = (False, False) if prec == "f32" else (True, True)
    assert seen == [inside]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (True, True)


def test_eval_cli_plt_raises(trees, armo_root, monkeypatch):
    """Once ``--plt`` raised (the overlays were not ported); now the CLI's
    ``--plt --plt_max 3`` writes the JAX CLI's three overlay files, byte
    for byte (the same f32 weights, bf16 images and predictions)."""
    jdir, pdir = trees["f32"]
    extra = ["--plt", "--plt_max", "3"]
    assert _run(jax_cli.main, jdir, _argv(armo_root, *extra),
                monkeypatch) == 0
    assert _run(cli.main, pdir, _argv(armo_root, *extra, "--platform",
                                      "cpu"), monkeypatch) == 0
    sub = os.path.join("output", "hrnet", "ours", "x", "eval_image",
                       "0_epoch")
    names = sorted(os.listdir(pdir / sub))
    assert names == sorted(os.listdir(jdir / sub)) == [
        f"iter_{i}.jpg" for i in range(3)]
    for name in names:
        assert (pdir / sub / name).read_bytes() == (
            jdir / sub / name).read_bytes(), name


def test_eval_cli_orbax_checkpoint_raises(trees, armo_root, monkeypatch):
    jdir, _ = trees["f32"]
    with pytest.raises(NotImplementedError, match="orbax"):
        _run(cli.main, jdir, _argv(armo_root, "--platform", "cpu"),
             monkeypatch)


def test_eval_cli_without_checkpoints_returns_1(tmp_path, armo_root,
                                                 monkeypatch):
    assert _run(cli.main, tmp_path, _argv(armo_root, "--platform", "cpu"),
                monkeypatch) == 1


def test_eval_cli_without_a_card_raises(tmp_path, armo_root, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(cli.main, tmp_path, _argv(armo_root), monkeypatch)


def test_find_checkpoints_matches_jax(tmp_path):
    for d in ("a/checkpoint-good", "a/b/checkpoint-3", "c/checkpoint-tmp1",
              "c/other", "checkpoint-x"):
        os.makedirs(tmp_path / d)
    got = cli.find_checkpoints(str(tmp_path))
    assert got == jax_cli.find_checkpoints(str(tmp_path))
    assert [os.path.relpath(p, tmp_path) for p in got] == [
        "a/b/checkpoint-3", "a/checkpoint-good", "checkpoint-x"]
    assert cli.THRESHOLD_REGIMES == jax_cli.THRESHOLD_REGIMES
