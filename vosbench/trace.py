"""The traced run's instruments: ``torch.profiler.record_function`` ranges
around calls into the program, put in from outside at run time (the
program is not edited), and a profiled slice of the window whose events
are read in memory.

:class:`Tracer` wraps a function of the program so that, while a slice is
being profiled, each call runs inside a range named ``vosbench.<label>`` and
leaves a record of its arguments (``record(args, kwargs) -> dict``), from
which the frozen counts work out the call's work. Outside a slice a wrapped
call costs one attribute test.

:meth:`Tracer.stop` reduces the slice to a :class:`Slice`: the device's busy
time, each range's host time, count and the device time of the kernels
launched inside it (on the same thread, nested ranges each charged), the
kernels by name, and the idle gaps with the range the host was in.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "vosbench."


@dataclass
class Slice:
    window_s: float
    busy_s: float
    host_s: Dict[str, float] = field(default_factory=dict)  # label → host seconds in its ranges
    count: Dict[str, int] = field(default_factory=dict)  # label → ranges
    device_s: Dict[str, float] = field(default_factory=dict)  # label → device seconds launched inside
    kernels: Dict[str, float] = field(default_factory=dict)  # device op name → seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host range, seconds), longest first
    calls: Dict[str, List[dict]] = field(default_factory=dict)  # label → records of calls in the slice
    extra: Dict[str, float] = field(default_factory=dict)  # the driver's own readings of the slice


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self._restore: List[Callable[[], None]] = []
        self._prof = None
        self.t_start = self.t_stop = None
        self.claims: List[Tuple[str, Tuple[str, ...]]] = []

    def range(self, label: str):
        """A range around harness code (the loop's own steps)."""
        if self.active:
            return torch.profiler.record_function(PREFIX + label)
        return contextlib.nullcontext()

    def wrap(self, owner, attr: str, label: str, record: Optional[Callable] = None) -> None:
        """Wrap ``owner.attr`` (a module's function or a class's method)."""
        if not self.enabled:
            return
        orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
        tracer = self

        def wrapped(*args, **kwargs):
            if not tracer.active:
                return orig(*args, **kwargs)
            with torch.profiler.record_function(PREFIX + label):
                out = orig(*args, **kwargs)
            if record is not None:
                tracer.calls[label].append(record(args, kwargs))
            return out

        # the program's function may keep state on itself under its own
        # name (a launch counter): the wrapper carries the same attributes
        functools.update_wrapper(wrapped, orig)
        setattr(owner, attr, wrapped)
        self._restore.append(lambda: setattr(owner, attr, orig))

    def unwrap(self) -> None:
        for undo in reversed(self._restore):
            undo()
        self._restore.clear()

    def warm(self, device) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer, which must not fall in the window."""
        if not self.enabled:
            return
        with self._profile():
            torch.zeros(1, device=device).add_(1)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def claim(self, pattern: str, labels: Tuple[str, ...]) -> None:
        """Device ops whose name contains ``pattern`` belong to the ranges
        ``labels``: the program's own kernels, launched through a library of
        its own, reach the profiler without a link to the op that launched
        them."""
        self.claims.append((pattern, tuple(labels)))

    def start(self, device) -> None:
        """Open the slice with the device drained, so that every device op
        in it was launched in it."""
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.calls.clear()
        self._prof = self._profile()
        self._prof.__enter__()
        self.t_start = time.perf_counter()
        self.active = True

    def stop(self, device) -> None:
        """Close the slice; :meth:`result` reads it once the window is over."""
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.t_stop = time.perf_counter()
        self.active = False
        self._prof.__exit__(None, None, None)

    def tick(self, elapsed: float, start_at: float, stop_at: float, device) -> None:
        """Open the slice ``start_at`` seconds into the window and close it
        at ``stop_at``; called between steps of the loop."""
        if not self.enabled:
            return
        if self.t_start is None and elapsed >= start_at:
            self.start(device)
        elif self.active and elapsed >= stop_at:
            self.stop(device)

    def finish(self, device) -> Optional[Slice]:
        """After the window: the slice read, or None without one."""
        if self.active:
            self.stop(device)
        return self.result() if self.t_stop is not None else None

    def result(self) -> Slice:
        out = reduce_events(self._prof.events(), self.t_stop - self.t_start, self.claims)
        out.calls = {k: list(v) for k, v in self.calls.items()}
        self._prof = None
        return out


def short_name(name: str, width: int = 96) -> str:
    """A device op's name without its return type and its final argument
    list, cut to ``width``."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name if len(name) <= width else name[: width - 3] + "..."


def reduce_events(events, window_s: float, claims=(), top: int = 10) -> Slice:
    """The slice's profiler events → :class:`Slice`. Times are the
    profiler's, in microseconds from its start. The window runs from the
    first device op to the last (the slice opens on a drained device and
    closes once it is drained again, so it holds all the slice's device
    work and none of the profiler's own start); without a device op it is
    ``window_s``. Device-side copies of the ranges (``vosbench.*`` on the
    device's timeline) are not device work. Each device op is charged to
    every range that was open around its launch on the launching thread."""
    device, ranges, launches = [], defaultdict(list), defaultdict(list)
    for e in events:
        dev_type = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
        start, stop = e.time_range.start, e.time_range.end
        if dev_type != "CPU":
            if not e.name.startswith(PREFIX):
                device.append((start, stop, e.name))
            continue
        if e.name.startswith(PREFIX):
            ranges[e.thread].append((start, stop, e.name[len(PREFIX):]))
        # the profiler hangs each device op on the innermost op or range
        # that was open on the host when it was launched
        linked = [k.duration for k in getattr(e, "kernels", None) or ()
                  if not any(pattern in k.name for pattern, _ in claims)]
        if linked:
            launches[e.thread].append((start, sum(linked)))
    begin_us = min((a for a, _, _ in device), default=0.0)
    end_us = max((b for _, b, _ in device), default=window_s * 1e6)
    busy = _union([(a, b) for a, b, _ in device if b > a])
    out = Slice(window_s=(end_us - begin_us) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6)
    kernels: Dict[str, float] = defaultdict(float)
    host, count, dev_s = defaultdict(float), defaultdict(int), defaultdict(float)
    for a, b, name in device:
        if b > a:
            kernels[short_name(name)] += (b - a) / 1e6
            for pattern, labels in claims:
                if pattern in name:
                    for label in labels:
                        dev_s[label] += (b - a) / 1e6
    out.kernels = dict(kernels)
    for thread, rs in ranges.items():
        ls = sorted(launches.get(thread, []))
        times = [t for t, _ in ls]
        cum = [0.0]
        for _, us in ls:
            cum.append(cum[-1] + us)
        for a, b, label in rs:
            host[label] += (b - a) / 1e6
            count[label] += 1
            i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
            dev_s[label] += (cum[j] - cum[i]) / 1e6
    out.host_s, out.count, out.device_s = dict(host), dict(count), dict(dev_s)
    gaps, prev = [], begin_us
    for a, b in busy + [(end_us, end_us)]:
        if a > prev:
            gaps.append((a - prev, prev))
        prev = max(prev, b)
    all_ranges = [r for rs in ranges.values() for r in rs]
    named = []
    for length, at in sorted(gaps, reverse=True)[:top]:
        inside = [r for r in all_ranges if r[0] <= at <= r[1]]
        named.append((max(inside)[2] if inside else "host.other", length / 1e6))
    out.gaps = named
    return out
