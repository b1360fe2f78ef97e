"""Host -> device input pipeline.

Counterpart of ``lighthand_tpu/data/pipeline.py``:

- host threads only decode/collate uint8 images + joint arrays (numpy);
  up to ``prefetch + 1`` batches are in flight in a thread pool;
- on the card each host batch is copied from pinned memory with
  ``non_blocking=True``, one batch ahead, so the copy of batch N+1 overlaps
  the step of batch N; on the CPU the loader yields CPU tensors;
- color jitter, ImageNet normalization and the Gaussian targets run on the
  device in the train and eval steps (K1, K2 and ``ops/color.py``);
- under a device mesh (``core/mesh.py``) every process walks the same
  global order and loads only its data index's rows of each batch (the
  JAX package's ``pindex`` split; the reference's dormant
  DistributedSampler, src/datasets/build.py:53-60).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from lighthand_tpu_torch.core.mesh import data_index
from lighthand_tpu_torch.data.records import Source
from lighthand_tpu_torch.ops.color import divide, normalize_imagenet


def preprocess_u8(images_u8: torch.Tensor,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """u8 NHWC -> ImageNet-normalised NHWC in ``out_dtype``: the eval path's
    ``DevicePreprocessor(jitter=False)`` of the JAX package (plain XLA there,
    plain PyTorch here)."""
    return normalize_imagenet(divide(images_u8.float(), 255.0)).to(out_dtype)


def _collate(samples, valid: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Stack samples into host arrays. ``valid`` (0/1 per sample) marks
    padding rows appended to fill the last batch; they are masked out
    downstream (train/step.py:make_eval_step)."""
    images = np.stack([s.image for s in samples])
    joints = np.stack([s.joints for s in samples]).astype(np.float32)
    aug = np.asarray([s.aug_enabled for s in samples], dtype=np.float32)
    noise = np.asarray([s.noise_enabled for s in samples], dtype=np.float32)
    hm_max = np.asarray([s.hm_max for s in samples], dtype=np.float32)
    if valid is None:
        valid = np.ones(len(samples), np.float32)
    batch = {"image_u8": images, "joints": joints, "aug_enabled": aug,
             "noise_enabled": noise, "hm_max": hm_max, "valid": valid}
    if samples[0].meta and "pose_ctgy" in samples[0].meta:
        # host-side metadata (stays off the device)
        batch["pose_ctgy"] = [s.meta["pose_ctgy"] for s in samples]
    return batch


class Loader:
    """Iterable over batches of tensors on ``device``.

    Fixed batch shapes: the ragged tail is either dropped (drop_last=True,
    training) or padded to a full batch by repeating its last row, with a
    ``valid`` mask of 0 on the padding (drop_last=False, evaluation).
    Under ``mesh`` a batch holds this process's rows of the global batch
    of ``batch_size`` (``valid`` sliced with them); the data axis must
    divide ``batch_size``."""

    def __init__(
        self,
        source: Source,
        batch_size: int,
        *,
        device: torch.device | str,
        shuffle: bool = False,
        seed: int = 9001,
        num_workers: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        mesh=None,
    ):
        self.index, self.count = data_index(mesh)
        if batch_size % self.count:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"over the {self.count} data-axis processes")
        self.source = source
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.source) // self.batch_size
        if not self.drop_last and len(self.source) % self.batch_size:
            n += 1
        return n

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.source))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _host_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n_full = len(order) // self.batch_size
        limit = n_full * self.batch_size if self.drop_last else len(order)
        with ThreadPoolExecutor(self.num_workers) as pool:
            # up to prefetch + 1 batch futures run at once; each decodes its
            # items serially (a nested pool.map would starve once all
            # workers hold batch tasks)
            def fetch(batch_idx):
                lo = batch_idx * self.batch_size
                hi = min(lo + self.batch_size, limit)
                rows = order[lo:hi]
                valid = np.ones(len(rows), np.float32)
                if len(rows) < self.batch_size:  # ragged tail, drop_last=False
                    pad = self.batch_size - len(rows)
                    rows = np.concatenate([rows, np.repeat(rows[-1:], pad)])
                    valid = np.concatenate([valid,
                                            np.zeros(pad, np.float32)])
                if self.count > 1:
                    per = self.batch_size // self.count
                    sl = slice(self.index * per, (self.index + 1) * per)
                    rows, valid = rows[sl], valid[sl]
                return _collate(self.source.getitems(rows), valid=valid)

            total = len(self)
            pending = [pool.submit(fetch, i)
                       for i in range(min(self.prefetch + 1, total))]
            next_submit = len(pending)
            for _ in range(total):
                batch = pending.pop(0).result()
                if next_submit < total:
                    pending.append(pool.submit(fetch, next_submit))
                    next_submit += 1
                yield batch

    def _put(self, host_batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in host_batch.items():
            if not isinstance(v, np.ndarray):
                out[k] = v  # host-side metadata (e.g. pose categories)
            elif self.device.type == "cpu":
                out[k] = torch.from_numpy(v)
            else:
                out[k] = torch.from_numpy(v).pin_memory().to(
                    self.device, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Yields batches on ``device``; each copy starts one batch ahead."""
        prev = None
        for host_batch in self._host_batches():
            cur = self._put(host_batch)  # asynchronous on the card
            if prev is not None:
                yield prev
            prev = cur
        if prev is not None:
            yield prev
