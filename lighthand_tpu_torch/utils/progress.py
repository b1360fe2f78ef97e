"""Terminal progress bar with moving-average ETA: a copy of
``lighthand_tpu/utils/progress.py``.

Own lightweight replacement for the reference's vendored ``progress`` lib
(src/utils/bar.py:27-332): same role (per-epoch bar + suffix with loss /
count / lr / ETA, method.py:77-107), tiny implementation.
"""

from __future__ import annotations

import sys
import time
from collections import deque


class Bar:
    def __init__(self, message: str, max: int, width: int = 32,
                 stream=sys.stderr):
        self.message = message
        self.max = max
        self.width = width
        self.index = 0
        self.suffix = ""
        self._stream = stream
        self._t0 = time.time()
        self._dt = deque(maxlen=10)
        self._last = self._t0
        self._enabled = stream is not None and stream.isatty()

    def next(self, n: int = 1):
        now = time.time()
        self._dt.append((now - self._last) / n)
        self._last = now
        self.index += n
        if self._enabled:
            self._render()

    @property
    def eta_seconds(self) -> float:
        if not self._dt:
            return 0.0
        rate = sum(self._dt) / len(self._dt)
        return rate * max(self.max - self.index, 0)

    def _render(self):
        frac = min(self.index / self.max, 1.0) if self.max else 1.0
        filled = int(self.width * frac)
        bar = "█" * filled + "░" * (self.width - filled)
        eta = int(self.eta_seconds)
        line = (f"\r{self.message} |{bar}| {self.index}/{self.max} "
                f"eta {eta // 60:d}:{eta % 60:02d} {self.suffix}")
        self._stream.write(line[:200])
        self._stream.flush()

    def finish(self):
        if self._enabled:
            self._stream.write("\n")
            self._stream.flush()
