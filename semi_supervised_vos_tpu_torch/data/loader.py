"""Host-side prefetching: a small thread pool decodes ahead of the device
loop (PIL decode releases the GIL)."""

from __future__ import annotations

import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


def prefetch(iterable_factory, length: int, depth: int = 4, workers: int = 2) -> Iterator:
    """Iterate ``iterable_factory(i)`` for i in range(length), decoding up to
    ``depth`` items ahead on a thread pool."""
    return prefetch_calls((functools.partial(iterable_factory, i) for i in range(length)), depth, workers)


def prefetch_calls(calls: Iterator, depth: int = 4, workers: int = 2) -> Iterator:
    """Run the zero-argument ``calls`` on a thread pool, up to ``depth``
    ahead, and yield their results in order. The iterator itself is advanced
    in the consumer's thread."""
    with ThreadPoolExecutor(workers) as pool:
        pending = deque()
        for call in calls:
            pending.append(pool.submit(call))
            if len(pending) >= depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def prefetch_dataset(dataset, depth: int = 4, workers: int = 2) -> Iterator:
    """Prefetching iterator over an indexable dataset."""
    return prefetch(dataset.__getitem__, len(dataset), depth, workers)
