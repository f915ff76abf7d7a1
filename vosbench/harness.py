"""What a driver is given and what it hands back.

A driver (``vosbench/drivers/<name>.py``, named by the traffic file's
``driver`` key) exposes ``run(ctx: Context) -> Outcome``: it makes its
inputs from the seed, sets the program up and warms every shape, calls
``ctx.window_started()``, measures for ``ctx.seconds``, then judges what the
window produced against the plain reference.
"""

from __future__ import annotations

import os
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from vosbench.trace import Slice, Tracer


@dataclass
class Context:
    workload: str
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_process: float  # perf_counter at the process's start
    t_window: Optional[float] = None
    host: Dict[str, float] = field(default_factory=dict)  # this process's CPU over the window
    tracer: Tracer = None
    control: bool = False  # read the control's numbers too (calibration only)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(self.trace)

    def mark(self, what: str) -> None:
        """Log the seconds since the process started at a step of set-up."""
        print(f"setup: {what} at {time.perf_counter() - self.t_process:.3f} s", file=sys.stderr, flush=True)

    def window_started(self) -> float:
        self._cpu0 = cpu_seconds()
        self.t_window = time.perf_counter()
        return self.t_window

    def window_closed(self) -> None:
        """Read the cores' worth of CPU this process used over the window,
        beside the machine's cores: a host-paced loop's rate follows the
        CPU time its work costs."""
        self.host = {"cores": float(os.cpu_count() or 0),
                     "own": (cpu_seconds() - self._cpu0) / (time.perf_counter() - self.t_window)}

    def slice_bounds(self) -> Tuple[float, float]:
        """Seconds into the window at which the traced slice starts and
        stops: a steady stretch after the first quarter, at most four
        seconds long."""
        start = max(1.0, 0.25 * self.seconds)
        return start, start + min(4.0, 0.4 * self.seconds)


def cpu_seconds() -> float:
    """This process's CPU time, all its threads, user and system."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, Tuple[float, str]]  # end-to-end name → (value, unit)
    readings: Dict[str, float]  # the numbers compared, by check name
    memory_peak_bytes: int
    slice: Optional[Slice] = None
    control: Dict[str, float] = field(default_factory=dict)  # the control's readings, when asked
    extra: Dict[str, object] = field(default_factory=dict)  # per-metric extra keys (sample counts)
