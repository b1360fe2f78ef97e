"""Metric accumulators: a copy of ``lighthand_tpu/utils/meters.py`` (the
reference duplicates AverageMeter at metric_logger.py:8 and
src/tools/dataset.py:303)."""

from __future__ import annotations


class AverageMeter:
    """Value/sum/count/avg; ``update_p`` accumulates (sum, count) pairs for
    visibility-weighted EPE (metric_logger.py:19-23)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0

    def update_p(self, val: float, count: float):
        self.val = val
        self.sum += val
        self.count += count
        self.avg = self.sum / self.count if self.count else 0.0
