"""Framework-wide constants (the port's copy of the JAX package's
``config.py``; reference ``src/config.py:10-14``)."""

from __future__ import annotations

import dataclasses
import multiprocessing
import os


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide constants.

    Attributes:
      continuous_frame: size of the dense tail of the memory-bank sampling
        schedule.
      dense_switch_frame: frame index after which the dense/sparse spatial
        weight split activates.
      num_classes: padded class budget (the 22-entry DAVIS palette table).
      cpu_count: host-parallelism width for evaluation.
    """

    continuous_frame: int = 4
    dense_switch_frame: int = 15
    num_classes: int = 22
    cpu_count: int = max(multiprocessing.cpu_count(), 1)


DEFAULT = Config()


def default_num_workers() -> int:
    """Decode threads of the training input pipeline: ``SVOS_NUM_WORKERS``,
    else the CPU count up to 8."""
    env = os.environ.get("SVOS_NUM_WORKERS")
    if env:
        return max(int(env), 1)
    return min(DEFAULT.cpu_count, 8)
