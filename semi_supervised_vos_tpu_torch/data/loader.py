"""Host-side prefetching: a small thread pool decodes ahead of the device
loop (PIL decode releases the GIL)."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


def prefetch(iterable_factory, length: int, depth: int = 4, workers: int = 2) -> Iterator:
    """Iterate ``iterable_factory(i)`` for i in range(length), decoding up to
    ``depth`` items ahead on a thread pool."""
    with ThreadPoolExecutor(workers) as pool:
        pending = deque()
        nxt = 0
        while nxt < length or pending:
            while nxt < length and len(pending) < depth:
                pending.append(pool.submit(iterable_factory, nxt))
                nxt += 1
            yield pending.popleft().result()


def prefetch_dataset(dataset, depth: int = 4, workers: int = 2) -> Iterator:
    """Prefetching iterator over an indexable dataset."""
    return prefetch(dataset.__getitem__, len(dataset), depth, workers)
