"""Training loop: counterpart of ``lighthand_tpu/train/loop.py`` (the
reference's train.py main loop + Runner_t/Runner_v, src/tools/train.py:
13-121, src/utils/method.py:12-309).

Per epoch: the cosine LR for the epoch -> fused train steps (K1; with
``--flip`` / ``--rot-aug`` the chain route and K2) over the loader, K
microbatches a dispatch and a ragged tail through a K=1 step -> eval steps
(K2) over the padded val loader -> early-stopping bookkeeping
(best val loss, patience counter --count) -> best-only checkpoint.
Scalars Loss/train & Loss/valid per epoch; the validation log reports EPE
in mm (x0.26, method.py:131) and PCK% (T=0.2 proportion, method.py:243).

In a process group (``core/dist.py``) the Trainer builds the
("data", "model") mesh (``core/mesh.py``), shards the model over it (HSDP)
where the model axis is above 1 and replicates it at 1, before Adam, loads each process's rows of every global batch, normalises
BatchNorm over the data axis, and reduces the losses and the eval sums over
it; rank 0 alone logs and writes scalars and checkpoints.

Differences from the JAX package: the device comes from ``--platform``
(the card unless the caller names the CPU; in a process group, the
process's own card); one process runs per device, not per host; the
per-epoch random draws come from one device ``torch.Generator`` seeded with
``seed + epoch`` at the start of each epoch (the same in every process,
which keeps its rows of the global batch's draws), so a resumed run draws
what an uninterrupted one would.

Prediction overlays (``TrainConfig.visualize``, on by default) are written
at train iterations {0, len//2, len-1} (the eval preprocess, then the
predict step) and at the same val iterations, to
``{output_dir}/{train,val}_image/{epoch}_epoch/iter_N.jpg``. Under a mesh
every process runs the predict step (a sharded model's forward gathers
its weights) and rank 0 alone draws and writes. A failure to draw, encode or
write an overlay is logged at debug and training goes on, as in the JAX
package; an error of the predict step on the device propagates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import statistics
import time

import torch
import torch.distributed as dist

from lighthand_tpu_torch.config import Config, check_supported
from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.dist import process_device
from lighthand_tpu_torch.core.mesh import (
    MeshSpec,
    create_mesh,
    is_host_leader,
    is_sharded,
)
from lighthand_tpu_torch.core.dtypes import DTypePolicy, numerics
from lighthand_tpu_torch.data import (
    Loader,
    build_dataset,
    preprocess_u8,
    source_heatmap_styles,
)
from lighthand_tpu_torch.data.cache import cached_sources
from lighthand_tpu_torch.models import get_model
from lighthand_tpu_torch.ops.metrics import PX_TO_MM_VALID_LOG
from lighthand_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    load_weights_only,
    resume_checkpoint,
    save_checkpoint,
)
from lighthand_tpu_torch.train.profiler import DispatchTimer, StepTimer, trace
from lighthand_tpu_torch.train.state import (
    TrainState,
    cosine_lr,
    create_train_state,
    set_learning_rate,
)
from lighthand_tpu_torch.train.step import (
    make_eval_step,
    make_fused_train_step,
    make_predict_step,
)
from lighthand_tpu_torch.train.watchdog import (
    StallWatchdog,
    check_rss_limit,
    host_rss_gb,
)
from lighthand_tpu_torch.utils.logging import (
    ScalarWriter,
    close_logger,
    colored,
    setup_logger,
)
from lighthand_tpu_torch.utils.meters import AverageMeter
from lighthand_tpu_torch.utils.misc import set_seed
from lighthand_tpu_torch.utils.visualize import save_overlay
from lighthand_tpu_torch.utils.progress import Bar

_EVAL_KEYS = ("loss_sum", "n_valid", "pck_sum", "pck_count", "epe_sum",
              "epe_count")


@dataclasses.dataclass
class EpochResult:
    train_loss: float
    val_loss: float
    pck: float
    epe_px: float
    images_per_sec: float


def _policy(cfg: Config) -> DTypePolicy:
    check_supported(cfg)
    if cfg.model.precision == "f32":
        return DTypePolicy.full_precision()
    if cfg.model.precision == "all_bf16":
        return DTypePolicy.all_bf16()  # numerically the bf16 policy
    if cfg.model.precision == "int8_fwd":
        return DTypePolicy.int8_fwd()  # int8 forward convs, STE backward
    return DTypePolicy()


def _overlay_iters(n: int) -> set:
    """The iterations of an epoch of ``n`` that draw overlays."""
    return {0, n // 2, n - 1}


def _pick_style(styles: set) -> str:
    """Uniform source tree -> static rasterizer; mixed -> per-sample select."""
    return next(iter(styles)) if len(styles) == 1 else "per_sample"


def _maybe_reset(cfg: Config, logger) -> None:
    """--reset semantics (argparser.py:121-139): confirm (unless --yes) and
    wipe the run + tensorboard dirs; the run's log starts anew."""
    if is_host_leader():
        _reset_run(cfg, logger)
    if dist.is_initialized():
        dist.barrier()  # the others go on once the run is wiped


def _reset_run(cfg: Config, logger) -> None:
    ckpt = os.path.join(cfg.output_dir, "checkpoint-good")
    if not (os.path.isdir(ckpt) and os.listdir(ckpt)):
        return
    if not cfg.train.assume_yes:
        ans = input("There is resume_point but do you want to delete?")
        if ans not in ("o", "y", "yes"):
            return
    close_logger(logger)
    for path in (cfg.tensorboard_dir, cfg.output_dir):
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
    setup_logger(cfg.name, cfg.output_dir)
    logger.info(colored("Ignore the check-point model", "green"))


class Trainer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.policy = _policy(cfg)
        self.device = resolve_device(process_device(cfg.platform)
                                     or cfg.platform)
        # None in one process; raises for a mesh that is not the world
        self.mesh = create_mesh(MeshSpec(cfg.mesh.data, cfg.mesh.model),
                                self.device)
        os.makedirs(cfg.output_dir, exist_ok=True)
        self.logger = setup_logger(cfg.name, cfg.output_dir)
        t0 = time.time()
        # set_seed seeds random/numpy globally and gives the init generator
        # (the same weights in every process); the reference seeds all
        # host RNGs up front (train.py:15-22)
        self.state: TrainState = create_train_state(
            get_model(cfg.model.name, cfg.model.num_joints,
                      policy=self.policy),
            set_seed(cfg.train.seed), lr=cfg.train.lr, device=self.device,
            mesh=self.mesh)
        self.generator = torch.Generator(device=self.device)
        self.logger.debug(f"init state on {self.device}: "
                          f"{time.time() - t0:.1f}s")

        self.best_loss = float("inf")
        self.start_epoch = 0
        self.count = 0
        self._setup_checkpoint_state()

        size = cfg.data.image_size
        hm = cfg.data.heatmap_size
        stride = size / hm
        self.scan_steps = max(1, cfg.train.steps_per_dispatch)

        # the target style (MSRA vs max-combine) is a property of the
        # source tree and picks the steps' rasterizer
        self.train_src, self.val_src = build_dataset(cfg)
        train_style = _pick_style(source_heatmap_styles(self.train_src))
        val_style = _pick_style(source_heatmap_styles(self.val_src))
        self._dispatch_fields = ["image_u8", "joints", "aug_enabled",
                                 "noise_enabled"]
        if train_style == "per_sample":
            self._dispatch_fields.append("hm_max")

        step_kw = dict(heatmap_size=hm, stride=stride, jitter=True,
                       target_style=train_style, flip=cfg.train.flip,
                       rot_deg=cfg.train.rot_aug,
                       compute_dtype=self.policy.compute_dtype,
                       device=self.device, mesh=self.mesh)
        self.train_step = make_fused_train_step(
            scan_steps=self.scan_steps, **step_kw)
        # K=1 step for the ragged tail of a K-microbatch dispatch
        self.train_step_k1 = (self.train_step if self.scan_steps == 1
                              else make_fused_train_step(scan_steps=1,
                                                         **step_kw))
        self.eval_step = make_eval_step(heatmap_size=hm, stride=stride,
                                        target_style=val_style,
                                        device=self.device, mesh=self.mesh)
        self.predict_step = make_predict_step(stride=stride,
                                              device=self.device)
        self.writer = ScalarWriter(cfg.tensorboard_dir,
                                   jsonl_dir=cfg.output_dir)
        self.dispatch_timer = DispatchTimer(self.device)
        # exit(86) if no completed dispatch for stall_timeout_s (arms at
        # the first heartbeat; 0 disables)
        self.watchdog = StallWatchdog(cfg.train.stall_timeout_s,
                                      logger=self.logger)

    # -- checkpoint / reset / transfer wiring (argparser.py:103-191) --------

    def _setup_checkpoint_state(self):
        cfg = self.cfg
        if cfg.train.reset:
            _maybe_reset(cfg, self.logger)
        elif checkpoint_exists(cfg.output_dir):
            self.best_loss, self.start_epoch, self.state, self.count = (
                resume_checkpoint(
                    self.state, cfg.output_dir,
                    restore_optimizer=not cfg.train.reset_optimizer,
                )
            )
            self.logger.info(
                colored(f"Loading ===> {cfg.output_dir}", "green"))
        if cfg.train.transfer:
            src = os.path.join("output", cfg.model.name, "frei", "ori",
                               "checkpoint-good")
            self.state = load_weights_only(self.state, src)
            self.logger.info(colored(f"Transfer_Loading ===> {src}", "green"))

    # -- data ---------------------------------------------------------------

    def make_loaders(self):
        cfg = self.cfg
        train_loader = Loader(
            self.train_src, cfg.data.batch_size, device=self.device,
            shuffle=True, seed=cfg.data.shuffle_seed,
            num_workers=cfg.data.num_workers, prefetch=cfg.data.prefetch,
            mesh=self.mesh,
        )
        # drop_last=False + the batch["valid"] mask: the early-stop signal
        # sees every validation sample
        val_loader = Loader(
            self.val_src, cfg.data.batch_size, device=self.device,
            shuffle=False, num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch, drop_last=False, mesh=self.mesh,
        )
        return train_loader, val_loader

    # -- epoch bodies ---------------------------------------------------------

    def _dispatch(self, step, batch, k: int):
        mark = self.dispatch_timer.start()
        self.state, metrics = step(self.state, self.generator, batch)
        self.dispatch_timer.stop(mark, k)
        return metrics["loss"]

    def _log_cache(self, epoch: int) -> None:
        """Log (to log.txt only) the share of each decoded-crop cache that
        is filled as the epoch starts: the share of its rows the epoch
        reads back instead of decoding."""
        for tag, src in (("train", self.train_src), ("valid", self.val_src)):
            for c in cached_sources(src):
                self.logger.debug(
                    f"epoch {epoch}: {tag} cache {c.cache_dir} hit_fraction "
                    f"{c.hit_fraction():.4f}")

    def run_train_epoch(self, loader: Loader, epoch: int) -> tuple[float, float]:
        cfg = self.cfg
        self._log_cache(epoch)
        loader.set_epoch(epoch)
        self.generator.manual_seed(cfg.train.seed + epoch)
        losses = AverageMeter()
        timer = StepTimer()
        bar = Bar(colored(f"{epoch}_TRAIN", "blue"), max=len(loader))

        k = self.scan_steps
        bsz = cfg.data.batch_size
        n_images = 0
        n_dispatch = 0
        t0 = time.time()
        pending = []  # (loss, n_images) read one dispatch late
        microbatches = []
        vis_iters = (_overlay_iters(len(loader)) if cfg.train.visualize
                     else set())
        trace_ctx = contextlib.ExitStack()

        def drain(limit: int) -> None:
            while len(pending) > limit:
                loss, n = pending.pop(0)
                losses.update(float(loss), n)

        for it, batch in enumerate(loader):
            if it in vis_iters:
                # overlays at {0, mid, last}, as the reference train
                # runner draws them (method.py:185-202)
                self._train_overlay(batch, epoch, it)
            microbatches.append(batch)
            if len(microbatches) < k:
                bar.next()
                continue
            if k == 1:
                dispatch = {name: microbatches[0][name]
                            for name in self._dispatch_fields}
            else:
                dispatch = {
                    name: torch.stack([b[name] for b in microbatches])
                    for name in self._dispatch_fields
                }
            microbatches = []
            loss = self._dispatch(self.train_step, dispatch, k)
            n_images += k * bsz
            n_dispatch += 1
            if cfg.train.trace and epoch == self.start_epoch:
                # trace dispatches 2-5 (skip the first, warm-up dispatch)
                if n_dispatch == 2:
                    trace_ctx.enter_context(
                        trace(os.path.join(cfg.output_dir, "trace")))
                elif n_dispatch == 6:
                    trace_ctx.close()
            # read losses one dispatch late: keeps the device queue full
            pending.append((loss, k * bsz))
            drain(1)
            self.watchdog.heartbeat()  # a completed loss read = progress
            timer.tick()
            if it % cfg.train.logging_steps == 0:
                bar.suffix = (f"loss: {losses.avg:.6f} | count: {self.count}"
                              f" | {timer.images_per_sec(k * bsz):.0f} img/s")
            bar.next()
        # the ragged tail of microbatches (< k of them) goes through the
        # K=1 step, so no loader batch is dropped
        for tail in microbatches:
            dispatch = {name: tail[name] for name in self._dispatch_fields}
            loss = self._dispatch(self.train_step_k1, dispatch, 1)
            n_images += bsz
            pending.append((loss, bsz))
            drain(1)
            self.watchdog.heartbeat()
        drain(0)
        trace_ctx.close()
        bar.finish()
        elapsed = time.time() - t0
        ips = n_images / elapsed if elapsed > 0 else 0.0
        times = self.dispatch_timer.collect()
        full = [ms for steps, ms in times if steps == k]
        self.writer.add_scalar("Loss/train", losses.avg, epoch)
        self.writer.add_scalar("perf/images_per_sec", ips, epoch)
        if full:
            self.writer.add_scalar("perf/dispatch_ms",
                                   statistics.median(full), epoch)
        self.logger.debug(
            f"epoch {epoch}: {ips:.1f} img/s, dispatch ms (steps, ms) "
            f"{[(s, round(ms, 3)) for s, ms in times]}, host rss "
            f"{host_rss_gb():.1f} GB")
        return losses.avg, ips

    def _train_overlay(self, batch, epoch: int, it: int) -> None:
        """Overlay the current predictions on a train batch's first row
        (reference method.py:185-202): the eval preprocess (no jitter),
        the predict step in every process, rank 0's drawing."""
        images = preprocess_u8(batch["image_u8"], self.policy.compute_dtype)
        pred, _ = self.predict_step(self.state, images)
        self._save_overlay(images, batch["joints"], pred, "train", epoch, it)

    def _save_overlay(self, images, gt_joints, pred_joints, phase: str,
                      epoch: int, it: int) -> None:
        """Rank 0 draws the first row's GT | prediction overlay and writes
        it; only the host half (drawing, encoding, the file) is caught."""
        if not is_host_leader():
            return
        # the row comes to the host once; a device error raises here
        image = images[0].float().cpu().numpy()
        gt = torch.as_tensor(gt_joints[0]).cpu().numpy()
        pred = torch.as_tensor(pred_joints[0]).cpu().numpy()
        t0 = time.perf_counter()
        try:
            save_overlay(image, gt, pred, self.cfg.output_dir, phase, epoch,
                         it)
        except Exception as e:  # an overlay must never stop training
            self.logger.debug(f"overlay failed: {e}")
            return
        self.logger.debug(f"overlay {phase} {epoch} {it}: "
                          f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    def run_valid_epoch(self, loader: Loader, epoch: int):
        losses, pcks, epes = AverageMeter(), AverageMeter(), AverageMeter()
        bar = Bar(colored(f"{epoch}_VALID", "blue"), max=len(loader))
        vis_iters = (_overlay_iters(len(loader)) if self.cfg.train.visualize
                     else set())
        for it, batch in enumerate(loader):
            images = preprocess_u8(batch["image_u8"],
                                   self.policy.compute_dtype)
            m = self.eval_step(self.state,
                               {"image": images, "joints": batch["joints"],
                                "valid": batch["valid"],
                                "hm_max": batch["hm_max"]})
            # exact sums/counts: padding rows of the final ragged batch
            # carry valid=0 and contribute nothing; one read per batch
            loss_sum, n_valid, pck_sum, pck_count, epe_sum, epe_count = (
                torch.stack([m[key] for key in _EVAL_KEYS]).tolist())
            losses.update_p(loss_sum, n_valid)
            pcks.update_p(pck_sum, pck_count)
            epes.update_p(epe_sum, epe_count)
            self.watchdog.heartbeat()
            if it in vis_iters:
                self._save_overlay(images, batch["joints"],
                                   m["pred_joints"], "val", epoch, it)
            bar.next()
        bar.finish()
        self.writer.add_scalar("Loss/valid", losses.avg, epoch)
        self.logger.debug(
            f"Test =>> epoch: {epoch} epe: {epes.avg * PX_TO_MM_VALID_LOG:.2f}mm, "
            f"count: {self.count} / {self.cfg.train.early_stop_count}, "
            f"total_pck: {pcks.avg * 100:.2f} %, best_loss: {self.best_loss:.7f}"
        )
        return losses.avg, pcks.avg * 100, epes.avg

    def describe_mesh(self) -> str:
        if self.mesh is None:
            return "one process"
        shape = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        return (f"{shape} over {dist.get_backend()}, model sharded "
                f"{is_sharded(self.state.model)}")

    # -- full run -------------------------------------------------------------

    def fit(self) -> EpochResult:
        cfg = self.cfg
        train_loader, val_loader = self.make_loaders()
        self.logger.info(colored(
            f"Path: {cfg.output_dir} | Dataset_len: {len(train_loader.source)}"
            f" | Dataset: {cfg.data.dataset} | Model: {cfg.model.name}"
            f" | Device: {self.device} | Mesh: {self.describe_mesh()}"
            f" | Start_epoch: {self.start_epoch}"
            f" | Max_count: {cfg.train.early_stop_count}"
            f" | Max_epoch: {cfg.train.epochs}", "yellow"))

        last = EpochResult(float("nan"), float("nan"), 0.0, 0.0, 0.0)
        self.watchdog.start()
        # an f32 run is full f32 on the card (core/dtypes.py:numerics)
        try:
            with numerics(self.policy):
                for epoch in range(self.start_epoch, cfg.train.epochs):
                    t0 = time.time()
                    lr = cosine_lr(cfg.train.lr, epoch, cfg.train.epochs)
                    self.state = set_learning_rate(self.state, lr)

                    train_loss, ips = self.run_train_epoch(train_loader,
                                                           epoch)
                    val_loss, pck, epe = self.run_valid_epoch(val_loader,
                                                              epoch)
                    last = EpochResult(train_loss, val_loss, pck, epe, ips)
                    self.writer.add_scalar("perf/epoch_seconds",
                                           time.time() - t0, epoch)

                    is_best = val_loss < self.best_loss
                    self.best_loss = min(val_loss, self.best_loss)
                    if is_best:
                        self.count = 0
                        save_checkpoint(self.state, cfg.output_dir, epoch,
                                        self.best_loss, self.count,
                                        model_info={
                                            "name": cfg.model.name,
                                            "precision": cfg.model.precision,
                                        })
                        self.watchdog.heartbeat()  # the save blocks too
                    else:
                        self.count += 1
                        if self.count == cfg.train.early_stop_count:
                            self.logger.info(
                                f"early stop at epoch {epoch} "
                                f"(count={self.count})")
                            break
                    # after the checkpoint decision; flush TensorBoard first,
                    # since the exit path is os._exit
                    self.writer.flush()
                    check_rss_limit(cfg.train.rss_limit_gb, self.logger)
        finally:
            self.watchdog.stop()
            self.writer.close()
        return last


def train_from_config(cfg: Config) -> EpochResult:
    return Trainer(cfg).fit()
