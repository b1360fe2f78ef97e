"""Decoded-crop cache: memmap post-crop samples beside the dataset tree.

Counterpart of ``lighthand_tpu/data/cache.py``, with the same layout and
invalidation rules. Every source is deterministic per index (LightHand
decodes + resizes fixed files, FreiHAND draws its augmentation from
``default_rng(seed*2_000_003 + idx)``, the RHD/GAN/InterHand crops are pure
functions of the record), so the first touch of item ``idx`` can write the
post-crop uint8 image + joints to a memmap and every later epoch reads it
back instead of decoding again.

Layout (``{cache_dir}/``):
  meta.json   {token, n, size, kdim, version}: any mismatch (or absence)
              invalidates the whole cache
  images.u8   uint8 memmap [N, S, S, 3]
  joints.f32  float32 memmap [N, 21, K]   (K = 2 train / 3 with visibility)
  flags.u8    uint8 memmap [N, 3]         (aug_enabled, noise_enabled, hm_max)
  filled.u8   uint8 memmap [N]            (1 = row is valid)

meta.json is written last at creation, so a crash mid-setup leaves no
valid half-cache; a crash mid-fill loses at most unflushed ``filled`` bits
(those rows decode again). The Loader's threads fill disjoint rows.

The port's cache lives in its own directory: ``maybe_cache`` mixes
``PORT_TAG`` into the token, so the JAX package (whose cv2 decode may
differ from the port's codec) and the port never read each other's rows.
Sources that emit per-sample ``meta`` dicts (the Armo eval set) are not
cached.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import List, Optional

import numpy as np

from lighthand_tpu_torch.data.records import (
    ConcatSource,
    Sample,
    Source,
    SubsetSource,
)

_VERSION = 1
PORT_TAG = "lighthand_tpu_torch"
_log = logging.getLogger("lighthand_tpu_torch.data.cache")
_warned_unwritable = False


def _token_digest(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()[:16]


class CachedSource(Source):
    """Wrap a deterministic ``Source`` with a lazily-filled memmap cache."""

    def __init__(self, base: Source, cache_dir: str, token: str):
        self.base = base
        self.cache_dir = cache_dir
        self.heatmap_style = getattr(base, "heatmap_style", "msra")
        n = len(base)

        meta_path = os.path.join(cache_dir, "meta.json")
        have = None
        if os.path.isfile(meta_path):
            try:
                with open(meta_path) as f:
                    have = json.load(f)
            except (json.JSONDecodeError, OSError):
                have = None

        digest = _token_digest(token)
        probe = None
        if (have and have.get("token") == digest and have.get("n") == n
                and have.get("version") == _VERSION):
            size, kdim = int(have["size"]), int(have["kdim"])
            want = have
        else:
            probe = base[0]
            if probe.meta:
                raise ValueError(
                    "CachedSource cannot wrap meta-bearing sources; "
                    "use maybe_cache() which skips them")
            size = int(probe.image.shape[0])
            kdim = int(probe.joints.shape[1])
            want = {"token": digest, "n": n, "size": size,
                    "kdim": kdim, "version": _VERSION}
        self._n, self._size, self._kdim = n, size, kdim

        shapes = {"images.u8": (np.uint8, (n, size, size, 3)),
                  "joints.f32": (np.float32, (n, 21, kdim)),
                  "flags.u8": (np.uint8, (n, 3)),
                  "filled.u8": (np.uint8, (n,))}
        if have != want:
            if os.path.isdir(cache_dir):
                shutil.rmtree(cache_dir)
            os.makedirs(cache_dir, exist_ok=True)
            # zero-filled backing files (sparse where the filesystem allows)
            for name, (dtype, shape) in shapes.items():
                np.memmap(os.path.join(cache_dir, name), dtype, "w+",
                          shape=shape).flush()
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(want, f)
            os.replace(tmp, meta_path)  # meta last = cache now valid

        self.images, self.joints, self.flags, self.filled = (
            np.memmap(os.path.join(cache_dir, name), dtype, "r+", shape=shape)
            for name, (dtype, shape) in shapes.items())
        if probe is not None and not self.filled[0]:
            self._store(0, probe)

    def _store(self, idx: int, s: Sample) -> None:
        self.images[idx] = s.image
        self.joints[idx] = s.joints
        self.flags[idx] = (s.aug_enabled, s.noise_enabled, s.hm_max)
        self.filled[idx] = 1  # last: readers only trust filled rows

    def _load(self, idx: int) -> Sample:
        f = self.flags[idx]
        return Sample(image=np.asarray(self.images[idx]),
                      joints=np.asarray(self.joints[idx]),
                      aug_enabled=bool(f[0]), noise_enabled=bool(f[1]),
                      hm_max=bool(f[2]))

    def hit_fraction(self) -> float:
        return float(np.mean(self.filled))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> Sample:
        idx = int(idx)
        if self.filled[idx]:
            return self._load(idx)
        s = self.base[idx]
        self._store(idx, s)
        return s

    def getitems(self, indices) -> List[Sample]:
        indices = [int(i) for i in indices]
        missing = [i for i in indices if not self.filled[i]]
        if missing:
            # one bulk fetch through the base (the TSV engine's bulk read)
            for i, s in zip(missing, self.base.getitems(missing)):
                self._store(i, s)
        return [self._load(i) for i in indices]


def maybe_cache(source: Source, dataset_root: str, token: str,
                enabled: bool = True,
                fingerprint_paths: Optional[List[str]] = None) -> Source:
    """Wrap ``source`` in a CachedSource under ``{dataset_root}/.lh_cache/``.

    ``token`` captures every config knob that changes sample bytes
    (dataset, phase, image_size, num_our, aug ratio, seed); ``PORT_TAG`` is
    mixed in. ``fingerprint_paths``: annotation/shard files whose
    mtime+size join the token, so a regenerated tree invalidates its cache.
    Returns ``source`` unchanged when disabled, when it is empty or emits
    meta dicts, and when the cache directory cannot be written (logged
    once: the samples are the same, only slower)."""
    global _warned_unwritable
    if not enabled or len(source) == 0:
        return source
    if source[0].meta:
        return source
    token = f"{PORT_TAG}|{token}"
    for p in fingerprint_paths or []:
        try:
            st = os.stat(p)
            token += f"|{p}:{st.st_mtime_ns}:{st.st_size}"
        except OSError:
            token += f"|{p}:absent"
    cache_dir = os.path.join(dataset_root, ".lh_cache", _token_digest(token))
    try:
        os.makedirs(cache_dir, exist_ok=True)
        return CachedSource(source, cache_dir, token)
    except OSError as exc:
        if not _warned_unwritable:
            _warned_unwritable = True
            _log.warning("decoded-crop cache off: cannot write %s (%s); "
                         "reading the dataset uncached", cache_dir, exc)
        return source


def cached_sources(source: Source) -> List[CachedSource]:
    """The CachedSources in a source tree (through subsets and concats)."""
    if isinstance(source, CachedSource):
        return [source]
    if isinstance(source, SubsetSource):
        return cached_sources(source.base)
    if isinstance(source, ConcatSource):
        return [c for s in source.sources for c in cached_sources(s)]
    return []
