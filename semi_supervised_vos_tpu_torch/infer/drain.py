"""Pipelined device-to-host mask drain.

Kernel launches return before the device finishes, so while chunk t+1's
work is queued, chunk t's masks can be copied to the host and upsampled
there. ``MaskDrain`` runs the conversion closures on ONE worker thread in
submission order, overlapping the device work the main thread keeps
queueing. The reference synchronises on every frame's ``.cpu()``
(``src/utils/inference_utils.py:74-87``).

While the recorder records (``utils/profiling.py``), each job carries the
submitting thread's chunk identifier into spans ``drain.queue`` (from
submission until the worker takes it) and ``drain.job``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List

from semi_supervised_vos_tpu_torch.utils.profiling import handoff


class MaskDrain:
    """Ordered single-worker pipeline for device→host mask conversion."""

    def __init__(self) -> None:
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._futs: List[Any] = []

    def submit(self, fn: Callable[[], Any]) -> None:
        """Queue ``fn`` (a conversion closure holding device tensors)."""
        self._futs.append(self._ex.submit(handoff(fn, "drain.queue", "drain.job")))

    def drain(self) -> List[Any]:
        """Block for all queued conversions; returns results in order."""
        out = [f.result() for f in self._futs]
        self._futs = []
        return out

    def close(self) -> None:
        self._ex.shutdown(wait=True)
