"""Logger + ANSI color + scalar writer: counterpart of
``lighthand_tpu/utils/logging.py``. In a process group only rank 0 logs
and writes scalars (``lighthand_tpu/utils/logging.py:61,85``).

Reference: setup_logger (src/utils/logger.py:12-101): a DEBUG-level named
logger, colored stdout at INFO, a flush-per-record FileHandler to
{output_dir}/log.txt; and the vendored termcolor ``colored``
(src/utils/bar.py:234).

Scalars (tags Loss/train, Loss/valid per epoch, method.py:214,280) go
ALWAYS to a plain scalars.jsonl next to the checkpoint, and to TensorBoard
when ``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

from lighthand_tpu_torch.core.mesh import is_host_leader

_COLORS = {"grey": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
           "magenta": 35, "cyan": 36, "white": 37}


def colored(text: str, color: Optional[str] = None) -> str:
    if color is None or os.environ.get("ANSI_COLORS_DISABLED"):
        return text
    return f"\033[{_COLORS[color]}m{text}\033[0m"


class FlushFileHandler(logging.FileHandler):
    """Flush per record: keeps logs live on slow or remote mounts
    (logger.py:31-79 motivation)."""

    def emit(self, record):
        super().emit(record)
        self.flush()


def setup_logger(name: str, save_dir: Optional[str]) -> logging.Logger:
    """The named logger, its handlers set anew: a second run in the same
    process logs to its own ``save_dir``."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    close_logger(logger)
    if not is_host_leader():
        logger.addHandler(logging.NullHandler())
        return logger
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setLevel(logging.INFO)
    sh.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s"))
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = FlushFileHandler(os.path.join(save_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


def close_logger(logger: logging.Logger) -> None:
    """Close and detach the handlers ``setup_logger`` added (the log file)."""
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()


class ScalarWriter:
    """Loss/train & Loss/valid scalars (method.py:214,280)."""

    def __init__(self, log_dir: str, jsonl_dir: Optional[str] = None):
        self._tb = self._jsonl = None
        if not is_host_leader():
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir)
        self._jsonl_path = os.path.join(jsonl_dir or log_dir, "scalars.jsonl")
        os.makedirs(os.path.dirname(self._jsonl_path), exist_ok=True)
        self._jsonl = open(self._jsonl_path, "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._jsonl is None:
            return
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def flush(self):
        """Push buffered TensorBoard events to disk now: called before paths
        that ``os._exit`` (check_rss_limit), which skip close() (the jsonl
        channel flushes per write)."""
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
