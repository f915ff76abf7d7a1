"""Tracing and per-phase timing (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

* :func:`trace`: a ``torch.profiler.profile`` over the CPU and, where there
  is a card, CUDA activities around the enclosed block, written as a Chrome
  trace into ``SVOS_TRACE_DIR`` (or the path given); nothing without one;
* :class:`PhaseTimer`: wall-clock accounting per phase, with a device fence
  (``sync=``: ``torch.cuda.synchronize`` of the tensor's card; nothing for a
  CPU tensor), reported as ``phase timing | name: …s (nx, … ms avg)``;
* :func:`annotate`: a named region in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

from semi_supervised_vos_tpu_torch.utils.logging import logger


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block into ``log_dir`` (default
    ``SVOS_TRACE_DIR``) as ``trace-<pid>-<ns>.json``; a no-op when neither is
    set."""
    log_dir = log_dir or os.environ.get("SVOS_TRACE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = Path(log_dir) / f"trace-{os.getpid()}-{time.time_ns()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    logger.info(f"profiler trace written to {path}")


def annotate(name: str):
    """Named region for profiler traces (cheap when not tracing)."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulates wall-clock per phase; ``report()`` logs a summary.

    Example::

        timer = PhaseTimer()
        with timer.phase("backbone"):
            feats = encode(frame)
        with timer.phase("propagate", sync=pred):
            pred = propagate(feats)
        timer.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None and sync.is_cuda:
                torch.cuda.synchronize(sync.device)  # device fence
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        parts = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            parts.append(f"{name}: {total:.3f}s ({n}x, {total / n * 1e3:.1f} ms avg)")
        if parts:
            logger.info("phase timing | " + " | ".join(parts))
        return dict(self.totals)
