"""ctypes bindings for the TSV engine (``csrc/tsv_engine.cpp``).

A copy of the JAX package's engine (``native/tsv_engine.cpp``), built like
the image codec with the host C++ compiler into ``build/lighthand_tpu_torch/``
at first use (``ops/kernels/_build.py``). There is one path: a failed build
or a failed call raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from lighthand_tpu_torch.ops.kernels import _build


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("tsv_engine")
    lib.lh_generate_lineidx.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.lh_generate_lineidx.restype = ctypes.c_int64
    lib.lh_b64_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_void_p]
    lib.lh_b64_decode.restype = ctypes.c_int64
    lib.lh_read_rows.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,   # offsets
        ctypes.c_int,      # n_rows
        ctypes.c_void_p,   # arena
        ctypes.c_void_p,   # arena_offsets
        ctypes.c_void_p,   # row_lens (out)
        ctypes.c_int64,    # max_row_len
    ]
    lib.lh_read_rows.restype = ctypes.c_int
    return lib


def generate_lineidx(tsv_path: str, idx_path: str) -> int:
    """Write one byte offset per line of ``tsv_path``; returns the rows."""
    rows = _lib().lh_generate_lineidx(tsv_path.encode(), idx_path.encode())
    if rows < 0:
        raise OSError(f"cannot index {tsv_path} into {idx_path}")
    return int(rows)


def read_rows(tsv_path: str, all_offsets: np.ndarray, indices) -> list:
    """Bytes of the rows ``indices`` (no trailing newline), in one C call.
    ``all_offsets`` is the whole lineidx array."""
    if len(indices) == 0:
        return []
    idx = np.asarray(indices, dtype=np.int64)
    offsets = np.ascontiguousarray(all_offsets[idx], dtype=np.int64)
    # upper bound on a row's length: the gap to the next offset (or EOF)
    total = os.path.getsize(tsv_path)
    nxt = np.where(idx + 1 < len(all_offsets),
                   all_offsets[np.minimum(idx + 1, len(all_offsets) - 1)],
                   total).astype(np.int64)
    lens = nxt - offsets
    arena_offsets = np.zeros(len(idx), dtype=np.int64)
    np.cumsum(lens[:-1], out=arena_offsets[1:])
    arena = np.empty(int(lens.sum()), dtype=np.uint8)
    row_lens = np.zeros(len(idx), dtype=np.int64)
    rc = _lib().lh_read_rows(tsv_path.encode(), offsets.ctypes.data, len(idx),
                             arena.ctypes.data, arena_offsets.ctypes.data,
                             row_lens.ctypes.data, int(lens.max()))
    if rc != 0:
        raise OSError(f"cannot read rows of {tsv_path}")
    return [arena[a:a + n].tobytes()
            for a, n in zip(arena_offsets.tolist(), row_lens.tolist())]


def b64_decode(data: str | bytes) -> np.ndarray:
    """base64 -> uint8 bytes; invalid input raises ``ValueError``."""
    raw = data.encode() if isinstance(data, str) else data
    out = np.empty(len(raw) * 3 // 4 + 3, dtype=np.uint8)
    n = _lib().lh_b64_decode(raw, len(raw), out.ctypes.data)
    if n < 0:
        raise ValueError("invalid base64 data")
    return out[:n]
