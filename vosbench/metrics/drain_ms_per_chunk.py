"""Host ms a chunk's masks spend in the drain: the copy of its
feature-resolution masks to the host and their upsample to full
resolution (``MaskDrain`` worker, ``nearest_resize_host``), from its device
work done, on the drain thread's own clock during the slice."""


def read(s):
    calls = s.calls.get("drain", [])
    return sum(c["s"] for c in calls) / len(calls) * 1e3 if calls else None
