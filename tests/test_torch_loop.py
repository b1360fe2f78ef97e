"""The port's training entry point (config, Trainer, checkpoints, CLI,
watchdog) against the JAX package's, on the CPU.

Trainer parity: resnet18 at 32x32, heatmap 8, batch 8, f32, jitter off
(``ratio_of_aug`` 0, so the run is deterministic in both frameworks), lr
1e-4, 2 epochs of 2 steps; the JAX Trainer's initial variables are copied
into the port's. Measured relative gaps of the per-epoch losses: epoch 0
train 1.7e-7, valid 4.2e-7; epoch 1 train 5.3e-4, valid 5.9e-6 (at lr 1e-5
the epoch-1 train gap is 3.3e-6: Adam's sign noise, ROADMAP.md Queue 3,
amplified by train-mode BatchNorm over 8 values a channel at layer4's 1x1
maps). The tolerances below are those with a margin of 4-25x. A semantic
slip (targets, normalize, loss scale, optimizer or LR schedule, loader
order, BN statistics) moves them by orders of magnitude more. PCK and EPE
are held against the JAX eval step fed the port's heatmaps, since a
random-init net has argmax near-ties below the two frameworks' forward
agreement (ROADMAP.md, Queue 3).
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lighthand_tpu.config import Config as JaxConfig
from lighthand_tpu.config import parse_args as jax_parse_args
from lighthand_tpu.train.loop import Trainer as JaxTrainer
from lighthand_tpu.train.step import make_eval_step as jax_eval_step
from lighthand_tpu_torch.cli import train as cli_train
from lighthand_tpu_torch.config import Config, parse_args
from lighthand_tpu_torch.data import preprocess_u8
from lighthand_tpu_torch.train import loop, profiler, step as port_step
from lighthand_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    read_model_info,
    save_checkpoint,
)
from lighthand_tpu_torch.train.profiler import annotate, trace
from lighthand_tpu_torch.train.watchdog import StallWatchdog, check_rss_limit
from lighthand_tpu_torch.utils.weights import resnet_from_flax

# relative tolerance per (tag, epoch)
LOSS_RTOL = {("Loss/train", 0): 1e-5, ("Loss/valid", 0): 1e-5,
             ("Loss/train", 1): 2e-3, ("Loss/valid", 1): 5e-5}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    torch's default of one thread per core oversubscribes the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# --------------------------------------------------------------- config


_ARGVS = [
    [],
    ["--root", "hrnet/frei", "--name", "2d", "--epoch", "100", "--count",
     "30", "--batch_size", "32", "--lr", "0.001", "--reset", "--yes"],
    ["--root", "simplebaseline/ours", "--name", "smoke", "--synthetic",
     "--batch_size", "32", "--num_our", "128", "--steps-per-dispatch", "3",
     "--epoch", "2", "--count", "5", "--yes", "--reset"],
    ["--eval", "--synthetic", "--precision", "f32", "--mesh-data", "1",
     "--plt", "--plt_max", "4", "--test"],
    ["--root", "hrnet/mix", "--ratio_of_other", "0.3", "--ratio_of_aug",
     "0.1", "--optim", "--transfer", "--trace", "--stall-timeout", "0",
     "--rss-limit-gb", "0", "--no-cache-crops", "--num-workers", "2",
     "--dataset-root", "/data", "--train_yaml", "x.yaml", "--flip",
     "--rot-aug", "15", "--model", "x", "--dataset", "rhd", "--view", "v",
     "--root_path", "runs", "--milestone", "3"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=range(len(_ARGVS)))
def test_parse_args_matches_jax(argv):
    got = dataclasses.asdict(parse_args(argv + ["--platform", "cpu"]))
    assert got.pop("platform") == "cpu"
    assert got == dataclasses.asdict(jax_parse_args(argv))
    assert parse_args(argv).platform is None  # the card


@pytest.mark.parametrize("argv", [
    ["--mesh-data", "4"], ["--mesh-model", "2"], ["--mesh-data", "2"],
    ["--mesh-data", "8", "--mesh-model", "2"]])
def test_parse_args_unported_options_raise(argv, tmp_path):
    """Once a raise at parse time (multi-GPU was not ported); now the mesh
    flags parse as JAX's do, and one process refuses a mesh larger than
    its world when the Trainer builds it, naming the launch: torch runs a
    process per device, and no run goes on over fewer devices."""
    got = dataclasses.asdict(parse_args(argv + ["--platform", "cpu"]))
    assert got.pop("platform") == "cpu"
    assert got == dataclasses.asdict(jax_parse_args(argv))
    cfg = _cfg(Config, tmp_path, "mesh")
    cfg.mesh = parse_args(argv).mesh
    with pytest.raises(ValueError, match="does not cover 1 devices.*torchrun"):
        loop.Trainer(cfg)


@pytest.mark.parametrize("precision", ["fp16", "int4", "BF16"])
def test_unknown_precision_raises_value_error(precision):
    """A Config built in code with none of the four policies raises,
    naming them; JAX's ``_policy`` would take it for bf16 (a chosen
    difference: the CLIs' ``--precision`` choices reject it in both)."""
    cfg = Config()
    cfg.model.precision = precision
    with pytest.raises(ValueError,
                       match="bf16, f32, all_bf16, int8_fwd") as info:
        loop._policy(cfg)
    assert precision in str(info.value)
    with pytest.raises(SystemExit):
        parse_args(["--precision", precision])
    with pytest.raises(SystemExit):
        jax_parse_args(["--precision", precision])


def test_parse_args_platform_choices():
    assert parse_args(["--platform", "cuda"]).platform == "cuda"
    with pytest.raises(SystemExit):
        parse_args(["--platform", "tpu"])


# --------------------------------------------------------------- trainer


def _cfg(cls, tmp_path, tag, epochs=2, **over):
    cfg = cls(name=f"resnet18/ours/{tag}", root_path=str(tmp_path))
    cfg.model.name = "resnet18"
    cfg.model.precision = "f32"
    cfg.data.dataset = "ours"
    cfg.data.synthetic = True
    cfg.data.image_size = 32
    cfg.data.heatmap_size = 8
    cfg.data.batch_size = 8
    cfg.data.num_our = 16
    cfg.data.num_workers = 2
    cfg.data.ratio_of_aug = 0.0
    cfg.train.epochs = epochs
    cfg.train.lr = 1e-4
    cfg.train.early_stop_count = 50
    cfg.train.visualize = False
    for key, value in over.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, value)
    cfg.output_dir = os.path.join(str(tmp_path), cfg.name)
    cfg.tensorboard_dir = os.path.join(str(tmp_path), "tb", tag)
    if cls is Config:
        cfg.platform = "cpu"
    return cfg


def _scalars(cfg, tag):
    with open(os.path.join(cfg.output_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def test_trainer_matches_jax_trainer(tmp_path):
    jcfg = _cfg(JaxConfig, tmp_path, "jax")
    jtrainer = JaxTrainer(jcfg)
    variables = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        {"params": jtrainer.state.params,
         "batch_stats": jtrainer.state.batch_stats})
    cfg = _cfg(Config, tmp_path, "port")
    trainer = loop.Trainer(cfg)
    trainer.state.model.load_state_dict(resnet_from_flax(variables, 18))
    jres, res = jtrainer.fit(), trainer.fit()

    for tag in ("Loss/train", "Loss/valid"):
        got, want = _scalars(cfg, tag), _scalars(jcfg, tag)
        assert sorted(got) == sorted(want) == [0, 1]
        for epoch in (0, 1):
            np.testing.assert_allclose(got[epoch], want[epoch],
                                       rtol=LOSS_RTOL[tag, epoch],
                                       err_msg=f"{tag} epoch {epoch}")
    np.testing.assert_allclose(res.val_loss, jres.val_loss,
                               rtol=LOSS_RTOL["Loss/valid", 1])
    assert trainer.state.step == 4

    # PCK / EPE: the port's eval step against JAX's on the port's heatmaps
    batch = next(iter(trainer.make_loaders()[1]))
    images = preprocess_u8(batch["image_u8"], torch.float32)
    got = trainer.eval_step(trainer.state, {"image": images,
                                            "joints": batch["joints"],
                                            "valid": batch["valid"]})
    trainer.state.model.eval()
    with torch.no_grad():
        pred = trainer.state.model(images.permute(0, 3, 1, 2)).numpy()
    pred_nhwc = jnp.asarray(pred.transpose(0, 2, 3, 1))
    jstate = jtrainer.state.replace(
        apply_fn=lambda variables, x, train=False: pred_nhwc)
    want = jax_eval_step(heatmap_size=8, stride=4.0)(jstate, {
        "image": jnp.asarray(images.numpy()),
        "joints": jnp.asarray(batch["joints"].numpy()),
        "valid": jnp.asarray(batch["valid"].numpy())})
    for k in ("pck_sum", "pck_count", "epe_count", "n_valid"):
        assert float(got[k]) == float(want[k]), k
    np.testing.assert_allclose(float(got["epe_sum"]), float(want["epe_sum"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        res.pck, 100 * float(got["pck_sum"]) / float(got["pck_count"]),
        rtol=1e-6)


@pytest.fixture
def counted(monkeypatch):
    """Calls of the two kernel wrappers (their plain twins on the CPU)."""
    calls = {"fused_aug_targets": 0, "heatmap_targets": 0}

    def count(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(port_step, "fused_aug_targets_cuda", count(
        "fused_aug_targets", port_step.fused_aug_targets_cuda))
    monkeypatch.setattr(port_step, "generate_target_batch_cuda", count(
        "heatmap_targets", port_step.generate_target_batch_cuda))
    return calls


def test_steps_per_dispatch_with_ragged_tail(tmp_path, counted):
    """40 samples at batch 8 with K=3: one K=3 dispatch and a 2-batch tail
    through the K=1 step, so no batch is dropped; the val set (8) is one
    eval batch. K1 runs once per optimizer step, K2 once per eval batch."""
    cfg = _cfg(Config, tmp_path, "k3", data__num_our=40,
               train__steps_per_dispatch=3)
    trainer = loop.Trainer(cfg)
    assert trainer.train_step_k1 is not trainer.train_step
    res = trainer.fit()
    assert np.isfinite(res.train_loss)
    assert trainer.state.step == 2 * 5
    assert counted == {"fused_aug_targets": 10, "heatmap_targets": 2}
    assert sorted(_scalars(cfg, "perf/dispatch_ms")) == [0, 1]


def _overlays(cfg) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), cfg.output_dir)
                  for d, _, files in os.walk(cfg.output_dir)
                  for f in files if f.endswith(".jpg"))


def test_trainer_writes_jax_overlay_files(tmp_path):
    """Overlays on (the default): the port's Trainer writes the files the
    JAX Trainer writes for an epoch (train iterations {0, len//2, len-1},
    the same val iterations), each a GT | prediction JPEG."""
    import cv2

    jcfg = _cfg(JaxConfig, tmp_path, "jax", epochs=1, train__visualize=True)
    JaxTrainer(jcfg).fit()
    cfg = _cfg(Config, tmp_path, "port", epochs=1, train__visualize=True)
    loop.Trainer(cfg).fit()
    got = _overlays(cfg)
    assert got == _overlays(jcfg)
    assert got == [os.path.join("train_image", "0_epoch", "iter_0.jpg"),
                   os.path.join("train_image", "0_epoch", "iter_1.jpg"),
                   os.path.join("val_image", "0_epoch", "iter_0.jpg")]
    for rel in got:
        assert cv2.imread(os.path.join(cfg.output_dir, rel)).shape == (
            32, 64, 3)


def test_trainer_logs_a_failed_overlay_and_trains_on(tmp_path, monkeypatch):
    """A failure to draw, encode or write an overlay is logged at debug
    (as the JAX Trainer logs it) and the epoch goes on."""
    def broken(*args):
        raise OSError("planted: disk full")

    monkeypatch.setattr(loop, "save_overlay", broken)
    cfg = _cfg(Config, tmp_path, "port", epochs=1, train__visualize=True)
    result = loop.Trainer(cfg).fit()
    assert np.isfinite(result.train_loss) and np.isfinite(result.val_loss)
    log = open(os.path.join(cfg.output_dir, "log.txt")).read()
    assert log.count("overlay failed: planted: disk full") == 3
    assert _overlays(cfg) == []


def test_trainer_predict_failure_propagates(tmp_path):
    """The predict step is not caught: an error on the device stops the
    run (no hidden fallback); only the host half of an overlay is."""
    cfg = _cfg(Config, tmp_path, "port", epochs=1, train__visualize=True)
    trainer = loop.Trainer(cfg)

    def broken(state, images):
        raise RuntimeError("planted: device fault")

    trainer.predict_step = broken
    with pytest.raises(RuntimeError, match="planted: device fault"):
        trainer.fit()


def _weights(trainer):
    return {k: v.clone() for k, v in trainer.state.model.state_dict().items()}


def test_two_epochs_equal_one_epoch_and_resume(tmp_path):
    """Resume restores model, BN stats, Adam and the step, and the epoch's
    draws and order depend on the epoch only: jitter on half the samples,
    the weights agree within 1e-6."""
    straight = loop.Trainer(_cfg(Config, tmp_path, "straight",
                                 data__ratio_of_aug=0.5))
    straight.fit()
    first = loop.Trainer(_cfg(Config, tmp_path, "split", epochs=1,
                              data__ratio_of_aug=0.5))
    first.fit()
    resumed = loop.Trainer(_cfg(Config, tmp_path, "split",
                                data__ratio_of_aug=0.5))
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    resumed.fit()
    assert resumed.state.step == straight.state.step == 4
    want = _weights(straight)
    for k, v in _weights(resumed).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=1e-6, msg=k)


def test_optim_flag_restarts_adam(tmp_path):
    loop.Trainer(_cfg(Config, tmp_path, "optim", epochs=1)).fit()
    kept = loop.Trainer(_cfg(Config, tmp_path, "optim"))
    fresh = loop.Trainer(_cfg(Config, tmp_path, "optim",
                              train__reset_optimizer=True))
    assert kept.start_epoch == fresh.start_epoch == 1
    assert len(kept.state.optimizer.state) > 0
    assert len(fresh.state.optimizer.state) == 0
    want = _weights(kept)
    for k, v in _weights(fresh).items():  # the weights are restored either way
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


def test_reset_yes_wipes_the_run(tmp_path, monkeypatch):
    cfg = _cfg(Config, tmp_path, "reset", epochs=1)
    loop.Trainer(cfg).fit()
    marker = os.path.join(cfg.output_dir, "stale.txt")
    open(marker, "w").close()

    monkeypatch.setattr("builtins.input", lambda prompt: "n")
    kept = loop.Trainer(_cfg(Config, tmp_path, "reset", train__reset=True))
    assert os.path.exists(marker) and kept.start_epoch == 0

    wiped = loop.Trainer(_cfg(Config, tmp_path, "reset", train__reset=True,
                              train__assume_yes=True))
    assert not os.path.exists(marker)
    assert not checkpoint_exists(cfg.output_dir)
    assert (wiped.start_epoch, wiped.best_loss, wiped.count) == (
        0, float("inf"), 0)
    wiped.logger.info("after the reset")
    with open(os.path.join(cfg.output_dir, "log.txt")) as f:
        assert "after the reset" in f.read()


def test_early_stop_at_count(tmp_path, monkeypatch):
    """count rises on every epoch without a better val loss and the run
    stops when it reaches --count; only the best epoch is saved."""
    cfg = _cfg(Config, tmp_path, "early", epochs=6,
               train__early_stop_count=2)
    trainer = loop.Trainer(cfg)
    val = iter([1.0, 0.5, 0.7, 0.6, 0.4, 0.3])
    monkeypatch.setattr(trainer, "run_train_epoch",
                        lambda loader, epoch: (0.1, 1.0))
    monkeypatch.setattr(trainer, "run_valid_epoch",
                        lambda loader, epoch: (next(val), 0.0, 0.0))
    res = trainer.fit()
    assert res.val_loss == 0.6 and trainer.count == 2
    assert trainer.best_loss == 0.5
    with open(os.path.join(cfg.output_dir, "last_checkpoint.json")) as f:
        assert json.load(f)["epoch"] == 1


def test_last_checkpoint_model_info(tmp_path):
    cfg = _cfg(Config, tmp_path, "info", epochs=1)
    loop.Trainer(cfg).fit()
    with open(os.path.join(cfg.output_dir, "last_checkpoint.json")) as f:
        marker = json.load(f)
    ckpt = os.path.join(cfg.output_dir, "checkpoint-good")
    assert marker == {"epoch": 0, "path": os.path.abspath(ckpt),
                      "model": {"name": "resnet18", "precision": "f32"}}
    assert read_model_info(ckpt) == marker["model"]
    assert read_model_info(str(tmp_path / "nowhere")) is None


def test_trainer_with_flip_and_rotation(tmp_path, counted):
    """``--flip --rot-aug 15`` on the CPU for one epoch: the chain route
    (K2 targets once a step and once an eval batch, K1 never), finite
    losses, jitter on half the samples."""
    argv = ["--flip", "--rot-aug", "15"]
    flags = parse_args(argv).train
    assert (flags.flip, flags.rot_aug) == (True, 15.0)
    cfg = _cfg(Config, tmp_path, "affine", epochs=1, data__ratio_of_aug=0.5,
               train__flip=flags.flip, train__rot_aug=flags.rot_aug)
    res = loop.Trainer(cfg).fit()
    assert np.isfinite(res.train_loss) and np.isfinite(res.val_loss)
    assert counted == {"fused_aug_targets": 0, "heatmap_targets": 2 + 1}
    assert sorted(_scalars(cfg, "Loss/train")) == [0]


@pytest.mark.parametrize("precision", ["all_bf16", "int8_fwd"])
def test_trainer_runs_the_all_bf16_and_int8_policies(tmp_path, precision):
    """The Trainer maps the precisions as the JAX one does (int8_fwd: every
    backbone conv quantized), trains with finite losses and records the
    precision for the eval CLI's serving policy."""
    from lighthand_tpu_torch.models.layers import QuantConv2d

    cfg = _cfg(Config, tmp_path, precision, epochs=1,
               model__precision=precision)
    trainer = loop.Trainer(cfg)
    n_quant = sum(isinstance(m, QuantConv2d)
                  for m in trainer.state.model.modules())
    assert n_quant == (20 if precision == "int8_fwd" else 0)
    result = trainer.fit()
    assert np.isfinite([result.train_loss, result.val_loss]).all()
    assert read_model_info(os.path.join(cfg.output_dir, "checkpoint-good")
                           ) == {"name": "resnet18", "precision": precision}


def _tf32():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_f32_trainer_runs_without_tf32(tmp_path, monkeypatch, precision):
    """Inside an f32 Trainer's run both TF32 switches read False (f32 is
    full f32 on the card, as the JAX package computes on the CPU);
    afterwards both are as they were. The bf16 policy leaves them alone."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    train_epoch = loop.Trainer.run_train_epoch

    def spy(self, *args):
        seen.append(_tf32())
        return train_epoch(self, *args)

    monkeypatch.setattr(loop.Trainer, "run_train_epoch", spy)
    cfg = _cfg(Config, tmp_path, precision, epochs=1,
               model__precision=precision)
    loop.Trainer(cfg).fit()
    inside = (False, False) if precision == "f32" else (True, True)
    assert seen == [inside]
    assert _tf32() == (True, True)


def test_transfer_loads_weights_only(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    donor = loop.Trainer(_cfg(Config, tmp_path, "donor", epochs=1))
    donor.fit()
    save_checkpoint(donor.state, os.path.join("output", "resnet18", "frei",
                                              "ori"), 7, 0.5, 3)
    warm = loop.Trainer(_cfg(Config, tmp_path, "warm",
                             train__transfer=True))
    assert (warm.start_epoch, warm.state.step) == (0, 0)
    assert len(warm.state.optimizer.state) == 0
    want = _weights(donor)
    for k, v in _weights(warm).items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("route", ["ours", "gan"])
def test_trainer_on_a_real_tree_fills_then_reads_the_cache(tmp_path, route):
    """Two epochs on a generated LightHand tree (MSRA targets): the first
    fills the decoded-crop cache, the second reads every row from it, which
    the log reports as hit_fraction 1. On a GAN tree (max targets, no cache
    on that route, as in the JAX package) the log reports no cache."""
    import torch_fixtures

    root = tmp_path / "datasets"
    if route == "ours":
        torch_fixtures.write_lighthand_tree(str(root), 16, 5)
    else:
        torch_fixtures.write_gan_tree(str(root), 20)
    cfg = _cfg(Config, tmp_path, f"real_{route}", data__synthetic=False,
               data__dataset=route, data__dataset_root=str(root))
    trainer = loop.Trainer(cfg)
    assert trainer._dispatch_fields[-1] == "noise_enabled"  # no per_sample
    result = trainer.fit()
    assert np.isfinite([result.train_loss, result.val_loss]).all()
    with open(os.path.join(cfg.output_dir, "log.txt")) as f:
        log = f.read()
    for epoch in (0, 1):
        lines = [ln for ln in log.splitlines()
                 if f"epoch {epoch}: train cache" in ln]
        if route == "gan":
            assert lines == [] and "cache" not in log
            continue
        assert len(lines) == 1, log
        frac = float(lines[0].rsplit(" ", 1)[1])
        assert frac == 1.0 if epoch == 1 else frac < 1.0
    assert sorted(_scalars(cfg, "Loss/train")) == [0, 1]


def test_cli_main_on_the_cpu_prints_done(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli_train.main([
        "--root", "simplebaseline/ours", "--name", "t", "--synthetic",
        "--platform", "cpu", "--num_our", "8", "--batch_size", "8",
        "--epoch", "1", "--num-workers", "2", "--yes"]) == 0
    out = capsys.readouterr().out
    assert "done: train_loss=" in out and "throughput=" in out
    run = tmp_path / "output" / "simplebaseline" / "ours" / "t"
    for name in ("scalars.jsonl", "last_checkpoint.json", "log.txt",
                 "checkpoint-good/state.pt"):
        assert (run / name).exists(), name


def test_cli_main_without_a_card_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--synthetic", "--num_our", "8", "--batch_size", "8",
                        "--epoch", "1"])
    assert not (tmp_path / "output").exists()


# --------------------------------------------------------------- guards


def test_stall_watchdog_calls_on_stall():
    stalls = []
    wd = StallWatchdog(0.2, on_stall=stalls.append, poll_s=0.02).start()
    try:
        time.sleep(0.3)
        assert stalls == []  # not armed before the first heartbeat
        wd.heartbeat()
        deadline = time.monotonic() + 5.0
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        wd.stop()
    assert len(stalls) == 1 and stalls[0] > 0.2
    off = StallWatchdog(0)
    assert not off.enabled and off.start()._thread is None


def test_check_rss_limit_calls_on_exceed():
    hits = []
    assert check_rss_limit(1e-9, on_exceed=lambda rss, lim: hits.append(
        (rss, lim))) == 1e-9
    assert len(hits) == 1 and hits[0][0] > 0
    assert check_rss_limit(0, on_exceed=hits.append) == 0 and len(hits) == 1


def test_trace_window_writes_a_chrome_trace(tmp_path):
    """The window's Chrome trace holds the program's spans as
    ``lighthand.*`` ranges."""
    with trace(str(tmp_path / "trace")):
        with annotate("loop.data_wait"):
            torch.ones(4, 4).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert "lighthand.loop.data_wait" in {e.get("name") for e in events}


def test_each_wait_for_a_batch_is_a_span():
    """The train epoch draws its batches through ``_waited``: the batches
    as they come, each wait (and the last, which ends the epoch) a
    ``loop.data_wait`` span under a profiler, none without one."""
    from torch.profiler import ProfilerActivity, profile

    profiler.spans(clear=True)
    assert list(loop._waited([{"a": 1}, {"a": 2}])) == [{"a": 1}, {"a": 2}]
    assert profiler.spans().spans == ()
    with profile(activities=[ProfilerActivity.CPU]):
        assert len(list(loop._waited([{}, {}, {}]))) == 3
    names = [s.name for s in profiler.spans(clear=True).spans]
    assert names == ["lighthand.loop.data_wait"] * 4
