"""Step timing and a profiler window: counterpart of
``lighthand_tpu/train/profiler.py``.

- ``StepTimer``: moving-average step time and images/sec, measured in the
  loop (a copy of the JAX package's);
- ``trace()``: a ``torch.profiler`` window around any steps, written as a
  Chrome trace (``trace.json``, loadable in Perfetto or chrome://tracing);
- ``annotate(name)``: a named range inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


class StepTimer:
    def __init__(self, window: int = 50):
        self._dt = deque(maxlen=window)
        self._last = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._dt.append(now - self._last)
        self._last = now

    @property
    def avg_step_seconds(self) -> float:
        return sum(self._dt) / len(self._dt) if self._dt else 0.0

    def images_per_sec(self, batch_size: int) -> float:
        dt = self.avg_step_seconds
        return batch_size / dt if dt > 0 else 0.0

    def eta_seconds(self, steps_remaining: int) -> float:
        return self.avg_step_seconds * steps_remaining


class DispatchTimer:
    """Each dispatch's time without a synchronisation: CUDA events around
    it on the card (device time from its first to its last launch), the
    host clock on the CPU, where a dispatch runs synchronously. Read with
    ``collect`` once the dispatches are known to be done."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._marks = []

    def start(self):
        if self._cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def stop(self, mark, steps: int) -> None:
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._marks.append((steps, mark, end))
        else:
            self._marks.append((steps, mark, time.perf_counter()))

    def collect(self) -> list:
        """[(optimizer steps, ms)] per dispatch since the last collect."""
        if self._cuda:
            out = [(k, start.elapsed_time(end))
                   for k, start, end in self._marks]
        else:
            out = [(k, (end - start) * 1e3) for k, start, end in self._marks]
        self._marks = []
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): run steps`` -> ``{dir}/trace.json``; the CUDA
    activity is recorded too when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range inside a trace (``with annotate("eval"): ...``), shown
    on the profiler's timeline and in its ``key_averages()``."""
    return torch.profiler.record_function(name)
