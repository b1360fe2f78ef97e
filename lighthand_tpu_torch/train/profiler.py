"""Step timing and a profiler window: counterpart of
``lighthand_tpu/train/profiler.py``.

- ``StepTimer``: moving-average step time and images/sec, measured in the
  loop (a copy of the JAX package's);
- ``trace()``: a ``torch.profiler`` window around any steps, written as a
  Chrome trace (``trace.json``, loadable in Perfetto or chrome://tracing);
- ``annotate(name)``: the program's one span primitive. While a
  ``torch.profiler`` window is open (``trace()`` or any other), a span is
  a ``lighthand.<name>`` range in the profiler (a ``cpu_op`` event), on
  the device trace's clock, and a record in memory, read with
  ``spans()``; with no window open it costs one check of a flag.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "lighthand."  # of every span's name
SPAN_LIMIT = 65_536  # spans kept in memory; later ones are counted only


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


class Span(NamedTuple):
    """One span: its range's name, its start and end on the clock of the
    profiler's host events (``time.time_ns()``), the index of the span
    that holds it in the same record (-1: none), and its label."""
    name: str
    start_ns: int
    end_ns: int | None  # None while the span is open
    parent: int
    label: str | None


class SpanLog(NamedTuple):
    """The spans recorded, in the order they opened, and how many more
    were counted but not kept (past ``SPAN_LIMIT``)."""
    spans: tuple
    dropped: int


class _Log:
    def __init__(self):
        self.rows = []  # [name, start_ns, end_ns, parent row, label]
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, row: list) -> None:
        with self.lock:
            if len(self.rows) < SPAN_LIMIT:
                self.rows.append(row)
            else:
                self.dropped += 1


_LOG = _Log()
_OPEN = threading.local()  # each thread's open spans, innermost last
_OFF = contextlib.nullcontext()


class _Span:
    """A span opened under a profiler window: its range in the profiler
    and its row in the record, stamped just inside the range. The range is
    torch's ``_RecordFunctionFast``, a median 6.7 us a span on an H100
    host where ``record_function`` takes 16, so the stamps lie within a
    few us of the range's ends."""
    __slots__ = ("_name", "_label", "_range", "_row")

    def __init__(self, name: str, label: str | None):
        self._name = name
        self._label = label

    def __enter__(self):
        stack = _OPEN.__dict__.setdefault("stack", [])
        self._range = torch._C._profiler._RecordFunctionFast(self._name)
        self._range.__enter__()
        self._row = [self._name, time.time_ns(), None,
                     stack[-1] if stack else None, self._label]
        _LOG.add(self._row)
        stack.append(self._row)
        return self

    def __exit__(self, *exc):
        _OPEN.stack.pop()
        self._row[2] = time.time_ns()
        self._range.__exit__(*exc)
        return False


def annotate(name: str, label: str | None = None):
    """A span (``with annotate("graph.replay"): ...``). Under an open
    ``torch.profiler`` window it is the range ``lighthand.<name>`` on the
    profiler's timeline and in its ``key_averages()``, and a record in
    memory with ``label``; outside one it is a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(PREFIX + name, label)


def spans(clear: bool = False) -> SpanLog:
    """The spans recorded so far in this process (under every profiler
    window opened); ``clear`` starts a new record."""
    global _LOG
    log = _LOG
    if clear:
        _LOG = _Log()
    with log.lock:
        rows, dropped = list(log.rows), log.dropped
    index = {id(row): i for i, row in enumerate(rows)}
    return SpanLog(tuple(Span(name, start, end, index.get(id(parent), -1),
                              label)
                         for name, start, end, parent, label in rows),
                   dropped)
