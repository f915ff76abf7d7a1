"""Minimal structured logger (``logger.info/.warning/.error``) on top of the
stdlib, with a timestamped single-line format."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s"


def _build_logger() -> logging.Logger:
    log = logging.getLogger("svos_torch")
    if not log.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
        log.propagate = False
    return log


logger = _build_logger()
