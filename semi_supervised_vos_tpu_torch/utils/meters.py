"""Running-average meter (reference ``src/utils/utils.py:14-31``; no
reference command uses it, but it is public surface of the JAX package's
``utils/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
