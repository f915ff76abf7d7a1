"""The port's recorder of spans and counters, and its Chrome trace.

* :func:`span` ``(name, device=None)``: a context manager around one piece
  of work (``engine.encode``, ``drain.job``, ``train.backward``, ...);
* :func:`count` ``(name, n=1)``: adds ``n`` to a counter
  (``upload.bytes``, ``lockstep.lane_steps``, ...);
* :func:`summary`: per span name its count, host seconds, self seconds
  (the span's time less what its child spans on the same thread cover) and
  device seconds, the same per enclosing span name (``within``), and every
  counter's total; :func:`reset` clears them;
* :func:`trace`: a ``torch.profiler`` Chrome trace of a block that also
  holds the spans of the threads the profiler does not see, and a logged
  summary of the card's idle gaps, each named by the span the host was in;
* :func:`profiled_run`: what ``SVOS_PROFILE`` and ``SVOS_TRACE_DIR`` do
  around a CLI run.

Recording is on while a ``torch.profiler`` session records in the process
(``torch.autograd.profiler._is_profiler_enabled``) and for the length of an
``SVOS_PROFILE=1`` run. Off, a span is one flag test returning a shared
object that does nothing, and a counter one flag test. On, a span keeps
its host interval (``time.perf_counter_ns``), its parent on the same
thread and an identifier shared by the spans of one chunk or one train
step (the spans given ``new_id=True`` open a new one; the other spans of
the thread, and the jobs it hands off with :func:`handoff`, carry the
latest), opens a profiler range ``svos.<name>`` while the profiler runs,
and with ``device`` on a card records a pair of CUDA timing events on the
current stream, read in :func:`summary` after a synchronise. Totals per
name are always kept; single spans up to :data:`MAX_SPANS`.

The range is an op's (``torch._C._profiler._RecordFunctionFast``), not a
``torch.profiler.record_function`` user range: the profiler copies a user
range onto the card's row of the trace, where it reads as device work,
while an op's range stays on the host's row, and the kernels the port
launches itself (through ``ctypes``, outside any PyTorch op) hang on it as
on their op.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from torch._C._profiler import _RecordFunctionFast as _range

from semi_supervised_vos_tpu_torch.utils.logging import logger

PREFIX = "svos."
MAX_SPANS = 100_000  # single spans kept for trace(); totals are kept past it
_PENDING_FOLD = 512  # device-timed spans queued before finished ones are folded in

_forced = False  # an SVOS_PROFILE run is recording
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_totals: Dict[tuple, list] = {}  # (name, within) -> [count, host ns, self ns, device ns | None]
_counters: Dict[str, int] = defaultdict(int)
_spans: List[tuple] = []  # (name, id, thread, start ns, stop ns, parent)
_pending: List[tuple] = []  # (start event, stop event, keys) not read yet
_dropped = 0


def recording() -> bool:
    """Whether spans and counters record now."""
    return _forced or _autograd_profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _thread():
    """This thread's open spans, current identifier and native id."""
    th = _local
    if not hasattr(th, "stack"):
        th.stack, th.id, th.tid = [], 0, threading.get_native_id()
    return th


class _Span:
    __slots__ = ("name", "device", "new_id", "t0", "child_ns", "rf", "events", "th")

    def __init__(self, name: str, device, new_id: bool):
        self.name, self.device, self.new_id = name, device, new_id

    def __enter__(self):
        th = self.th = _thread()
        if self.new_id:
            th.id = next(_ids)
        th.stack.append(self)
        self.child_ns = 0
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _range(PREFIX + self.name)
            self.rf.__enter__()
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True), stream)
            self.events[0].record(stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        stack = self.th.stack
        stack.pop()
        dur = t1 - self.t0
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += dur
        within = {s.name for s in stack} - {self.name}
        _add(self.name, within, dur, dur - self.child_ns, self.events,
             (self.name, self.th.id, self.th.tid, self.t0, t1, parent.name if parent is not None else None))
        return False


def span(name: str, device: Optional[torch.device] = None, new_id: bool = False):
    """A context manager recording the enclosed work as span ``name``.
    ``device``: where the work runs; on a card the span is timed there too,
    on its current stream. ``new_id``: the span starts a new chunk or step
    identifier."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, new_id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    with _lock:
        _counters[name] += n


def current_id() -> int:
    """This thread's current chunk or step identifier (0 before any)."""
    return _thread().id


def _add(name, within, dur, self_ns, events, record) -> None:
    global _dropped
    keys = [(name, None)] + [(name, w) for w in within]
    with _lock:
        for key in keys:
            t = _totals.get(key)
            if t is None:
                t = _totals[key] = [0, 0, 0, None]
            t[0] += 1
            t[1] += dur
            t[2] += self_ns
        if len(_spans) < MAX_SPANS:
            _spans.append(record)
        else:
            _dropped += 1
        if events is not None:
            _pending.append((events[0], events[1], keys))
            fold = len(_pending) >= _PENDING_FOLD
        else:
            fold = False
    if fold:
        _read_events(wait=False)


def _read_events(wait: bool) -> None:
    """Fold the device time of the timed spans whose events have passed
    (all of them with ``wait``, after a synchronise) into the totals."""
    with _lock:
        pending = list(_pending)
        _pending.clear()
    left = []
    for e0, e1, keys in pending:
        if wait:
            e1.synchronize()
        elif not e1.query():
            left.append((e0, e1, keys))
            continue
        ns = int(e0.elapsed_time(e1) * 1e6)
        with _lock:
            for key in keys:
                t = _totals[key]
                t[3] = (t[3] or 0) + ns
    if left:
        with _lock:
            _pending[:0] = left


def _interval(name: str, t0_ns: int, t1_ns: int, span_id: int) -> None:
    """Record span ``name`` from ``t0_ns`` to ``t1_ns`` on this thread with
    identifier ``span_id``: a wait that began on another thread."""
    th = _thread()
    _add(name, (), t1_ns - t0_ns, t1_ns - t0_ns, None, (name, span_id, th.tid, t0_ns, t1_ns, None))


def handoff(fn, queue: Optional[str] = None, job: Optional[str] = None):
    """``fn`` to run on another thread under this thread's current
    identifier: span ``queue`` from now until it starts, span ``job``
    around it. ``fn`` itself while nothing records."""
    if not recording():
        return fn
    span_id, t_submit = current_id(), time.perf_counter_ns()

    def run(*args, **kwargs):
        th = _thread()
        prev, th.id = th.id, span_id
        try:
            if queue is not None:
                _interval(queue, t_submit, time.perf_counter_ns(), span_id)
            with span(job) if job is not None else _OFF:
                return fn(*args, **kwargs)
        finally:
            th.id = prev

    return run


def summary() -> dict:
    """``{"spans": {name: {"count", "host_s", "self_s", "device_s",
    "within": {enclosing name: the same four}}}, "counters": {name:
    total}, "kept": single spans kept, "dropped": single spans past the
    cap}``; ``device_s`` is None for a span never timed on a card. Waits
    for the card when timed spans are pending. Clears nothing."""
    _read_events(wait=True)
    spans: Dict[str, dict] = {}
    with _lock:
        totals = sorted(_totals.items(), key=lambda kv: (kv[0][0], kv[0][1] or ""))
        for (name, within), (n, host, self_ns, dev) in totals:
            row = {"count": n, "host_s": host / 1e9, "self_s": self_ns / 1e9,
                   "device_s": None if dev is None else dev / 1e9}
            entry = spans.setdefault(name, {"within": {}})
            if within is None:
                entry.update(row)
            else:
                entry["within"][within] = row
        return {"spans": spans, "counters": dict(_counters), "kept": len(_spans), "dropped": _dropped}


def records() -> List[dict]:
    """The single spans kept, in the order they closed."""
    with _lock:
        kept = list(_spans)
    return [{"name": n, "id": i, "thread": tid, "start_ns": a, "stop_ns": b, "parent": p}
            for n, i, tid, a, b, p in kept]


def reset() -> None:
    """Forget every span and counter."""
    global _dropped
    with _lock:
        _totals.clear()
        _counters.clear()
        _spans.clear()
        _pending.clear()
        _dropped = 0


def report() -> None:
    """Log :func:`summary` as one ``phase timing | name: …s (nx, … ms
    avg)`` line, spans by host time, then the counters; nothing when
    nothing was recorded."""
    s = summary()
    parts = []
    for name, r in sorted(s["spans"].items(), key=lambda kv: -kv[1]["host_s"]):
        part = f"{name}: {r['host_s']:.3f}s ({r['count']}x, {r['host_s'] / r['count'] * 1e3:.1f} ms avg)"
        if r["device_s"] is not None:
            part += f" device {r['device_s']:.3f}s"
        parts.append(part)
    parts += [f"{name}: {total}" for name, total in sorted(s["counters"].items())]
    if parts:
        logger.info("phase timing | " + " | ".join(parts))


@contextlib.contextmanager
def profiled_run():
    """Around a CLI run: under ``SVOS_PROFILE=1`` record from the start and
    log :func:`report` once at the end; under ``SVOS_TRACE_DIR`` write
    :func:`trace` of the run."""
    global _forced
    on = os.environ.get("SVOS_PROFILE", "") not in ("", "0")
    if on:
        reset()
        _forced = True
    try:
        with trace():
            yield
    finally:
        if on:
            _forced = False
            report()


# ---- trace() ---------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")  # the profiler's own ranges on the host's rows
LOOP_SPANS = ("engine.step", "train.step")  # the steady loop starts with the first of these


def _realtime_offset_ns() -> int:
    """CLOCK_REALTIME less ``perf_counter_ns`` now: the profiler stamps its
    events in nanoseconds of the realtime clock."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def _merge_spans(data: dict, kept: List[tuple], offset_ns: int, owner: int) -> int:
    """Add the kept spans of threads with no ``svos.*`` event in the
    written trace to its ``traceEvents``, on its time base; returns how
    many. The trace's ``ts`` is microseconds of the realtime clock from
    ``baseTimeNanoseconds``; the spans of the profiling thread, which are
    in both, correct any remaining shift."""
    events = data.setdefault("traceEvents", [])
    base = int(data.get("baseTimeNanoseconds", 0))
    ranges = [e for e in events if e.get("cat") in HOST_CATS and str(e.get("name", "")).startswith(PREFIX)]
    pid = ranges[0]["pid"] if ranges else os.getpid()
    seen_tids = {e.get("tid") for e in ranges}

    def ts(ns):
        return (ns + offset_ns - base) / 1e3

    # the same span as the trace and the recorder stamp it, name by name in order
    traced = defaultdict(list)
    for e in ranges:
        if e.get("tid") == owner:
            traced[e["name"][len(PREFIX):]].append(float(e["ts"]))
    ours = defaultdict(list)
    for name, _, tid, a, _, _ in kept:
        if tid == owner:
            ours[name].append(ts(a))
    shifts = sorted(t - o for name in traced if len(traced[name]) == len(ours[name])
                    for t, o in zip(sorted(traced[name]), sorted(ours[name])))
    shift = shifts[len(shifts) // 2] if shifts else 0.0
    added, named = 0, set()
    for name, span_id, tid, a, b, parent in kept:
        if tid == owner or tid in seen_tids:
            continue
        events.append({"ph": "X", "cat": "svos_span", "name": PREFIX + name, "pid": pid, "tid": tid,
                       "ts": ts(a) + shift, "dur": (b - a) / 1e3, "args": {"id": span_id, "parent": parent}})
        named.add(tid)
        added += 1
    names = {t.native_id: t.name for t in threading.enumerate()}
    for tid in named:
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": names.get(tid, f"thread {tid}")}})
    return added


def idle_summary(events: List[dict], top: int = 10) -> Optional[dict]:
    """The card's idle share over a trace's events, from the start of the
    first ``engine.step`` or ``train.step`` span (the first device op where
    there is none) to the last device op, and the ``top`` longest gaps in
    it, each named by the innermost ``svos.*`` span open at its start on
    any thread (the latest started), or ``host.other``. ``setup_s``: from
    the first device op to the window's start, left out of it (kernel
    builds, weights, warm-up). None without a device op."""
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    if not device:
        return None
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"][len(PREFIX):]) for e in events
             if e.get("ph") == "X" and e.get("cat") in HOST_CATS + ("svos_span",)
             and str(e.get("name", "")).startswith(PREFIX)]
    first, end = device[0][0], max(b for _, b in device)
    loop = [a for a, _, name in spans if name in LOOP_SPANS and a < end]
    begin = max(first, min(loop)) if loop else first
    busy, gaps, reach = 0.0, [], begin
    for a, b in device:
        if b <= reach:
            continue
        if a > reach:
            gaps.append((a - reach, reach))
        busy += b - max(a, reach)
        reach = b
    named = []
    for length, at in sorted(gaps, reverse=True)[:top]:
        inside = [s for s in spans if s[0] <= at <= s[1]]
        named.append((max(inside)[2] if inside else "host.other", length / 1e3))
    window = (end - begin) / 1e6
    return {"window_s": window, "idle_share": 1.0 - busy / 1e6 / window if window > 0 else 0.0,
            "setup_s": (begin - first) / 1e6, "gaps_ms": named}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block into ``log_dir`` (default
    ``SVOS_TRACE_DIR``) as ``trace-<pid>-<ns>.json``; a no-op when neither is
    set. The written trace also holds the spans of threads the profiler
    does not see (the mask drain, the PNG writers) on their own rows. With
    device activity it logs the card's idle share from the first step on
    and its ten longest idle gaps, each named by span. Yields a dict that holds ``path``,
    ``spans_added`` and ``idle`` (:func:`idle_summary`) once the block is
    done."""
    out: dict = {}
    log_dir = log_dir or os.environ.get("SVOS_TRACE_DIR")
    if not log_dir:
        yield out
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    owner = threading.get_native_id()
    with _lock:
        first = len(_spans)
    with torch.profiler.profile(activities=activities) as prof:
        offset = _realtime_offset_ns()
        yield out
    with _lock:
        kept = _spans[first:]
    path = Path(log_dir) / f"trace-{os.getpid()}-{time.time_ns()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    out["spans_added"] = _merge_spans(data, kept, offset, owner)
    path.write_text(json.dumps(data))
    out["path"] = path
    logger.info(f"profiler trace written to {path}")
    out["idle"] = idle = idle_summary(data["traceEvents"])
    if idle is not None:
        gaps = ", ".join(f"{name} {ms:.2f} ms" for name, ms in idle["gaps_ms"])
        logger.info(f"device idle {100 * idle['idle_share']:.1f}% of {idle['window_s']:.3f} s from the first step "
                    f"(set-up before it {idle['setup_s']:.3f} s, left out); longest gaps: {gaps}")
