"""Validation-loss plateau detection (reference
``src/utils/early_stopping.py``), the port's copy of the JAX package's
``train/early_stopping.py``: a pure transition, :func:`plateau_update`, and
:class:`EarlyStopping`, which saves the best checkpoint.

As there, a non-finite loss (validation runs every 10th epoch, the other
epochs report NaN) carries no signal: it neither advances the stale counter
nor touches the best checkpoint.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class PlateauMonitor:
    """The best validation loss so far."""

    best_loss: float = math.inf
    best_epoch: int = -1
    stale: int = 0


def plateau_update(monitor: PlateauMonitor, val_loss: float, epoch: int, *, patience: int = 7,
                   min_delta: float = 0.0) -> Tuple[PlateauMonitor, bool, bool]:
    """``(monitor, loss, epoch) -> (monitor', improved, stop)``: ``stop``
    once ``patience`` informative validations in a row failed to beat the
    best loss by more than ``min_delta``."""
    if not math.isfinite(val_loss):
        return monitor, False, False
    if val_loss < monitor.best_loss - min_delta:
        return PlateauMonitor(float(val_loss), int(epoch), 0), True, False
    bumped = replace(monitor, stale=monitor.stale + 1)
    return bumped, False, bumped.stale >= patience


class EarlyStopping:
    """:func:`plateau_update` with a ``save_fn(target)`` called on every
    improvement, ``target`` being ``directory / filename``."""

    def __init__(self, directory, *, patience: int = 7, min_delta: float = 0.0, filename: str = "model.pth.tar",
                 save_fn: Optional[Callable] = None, log: Optional[Callable[[str], None]] = None):
        self.monitor = PlateauMonitor()
        self.patience = patience
        self.min_delta = min_delta
        self.target = Path(directory) / filename
        self.save_fn = save_fn
        self.log = log or (lambda _msg: None)

    def __call__(self, val_loss, epoch: int) -> bool:
        prev = self.monitor
        self.monitor, improved, stop = plateau_update(prev, float(val_loss), epoch, patience=self.patience,
                                                      min_delta=self.min_delta)
        if improved:
            self.log(f"best val loss {prev.best_loss:.6f} -> {self.monitor.best_loss:.6f} at epoch {epoch}; "
                     f"snapshotting to {self.target}")
            if self.save_fn is not None:
                self.save_fn(self.target)
        elif self.monitor.stale != prev.stale:
            self.log(f"no improvement for {self.monitor.stale}/{self.patience} validations")
        if stop:
            self.log(f"plateau reached — best epoch {self.monitor.best_epoch} (val loss {self.monitor.best_loss:.6f})")
        return stop

    @property
    def best_epoch(self) -> int:
        return self.monitor.best_epoch
