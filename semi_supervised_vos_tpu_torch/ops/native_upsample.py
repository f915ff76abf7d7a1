"""ctypes bridge to the nearest-neighbour mask upsampler
(``csrc/host/upsample.cpp``): the port's counterpart of
``semi_supervised_vos_tpu/ops/native_upsample.py``.

Built like ``data/native_decode.py`` (``g++`` at first use, into
``build/host/``). At first use a probe at a non-integer scale is upsampled
by both paths and compared byte for byte with the numpy mapping of
``ops/resize.py::nearest_resize_host``; a failed build or a mismatch keeps
numpy for the process, with one log line saying why.

On by default: one row-gather loop beats numpy's two ``np.take`` passes
even on one thread, and it sits on the mask drain's critical path.
``SVOS_NATIVE_UPSAMPLE=0`` forces numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from semi_supervised_vos_tpu_torch.utils.logging import logger

_lib = None
_state: Optional[str] = None  # None = undecided, "on", "off"
reason: str = ""  # why the upsampler is off ("" while on or undecided)


def _numpy_twin(x: np.ndarray, out_hw) -> np.ndarray:
    rows = np.minimum(np.arange(out_hw[0]) * x.shape[-2] // out_hw[0], x.shape[-2] - 1)
    cols = np.minimum(np.arange(out_hw[1]) * x.shape[-1] // out_hw[1], x.shape[-1] - 1)
    return np.take(np.take(x, rows, axis=-2), cols, axis=-1)


def _self_check(lib) -> bool:
    """The native bytes equal the numpy mapping's on a (3, 60, 107) probe
    upsampled to 480 x 854."""
    probe = np.random.default_rng(0).integers(0, 22, size=(3, 60, 107), dtype=np.uint8)
    got = np.empty((3, 480, 854), np.uint8)
    rc = lib.svos_nearest_u8(probe.ctypes.data, 3, 60, 107, got.ctypes.data, 480, 854, 2)
    return rc == 0 and np.array_equal(got, _numpy_twin(probe, (480, 854)))


def _decide() -> str:
    global _lib, _state, reason
    if _state is not None:
        return _state
    if os.environ.get("SVOS_NATIVE_UPSAMPLE", "1") != "1":
        _state, reason = "off", "SVOS_NATIVE_UPSAMPLE is not 1"
        return _state
    try:
        from semi_supervised_vos_tpu_torch.ops._build import build_failure, build_host

        lib = ctypes.CDLL(str(build_host("upsample", ["-O3", "-lpthread"])))
        lib.svos_nearest_u8.restype = ctypes.c_int
        lib.svos_nearest_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        ok = _self_check(lib)
        reason = "" if ok else "its bytes differ from the numpy mapping's"
    except (OSError, subprocess.SubprocessError) as err:
        ok, reason = False, build_failure(err)
    if ok:
        _lib, _state = lib, "on"
    else:
        logger.info(f"native upsampler off: {reason}; using numpy")
        _state = "off"
    return _state


def available() -> bool:
    """Build and check once per process."""
    return _decide() == "on"


def nearest_u8(x: np.ndarray, out_hw) -> Optional[np.ndarray]:
    """(..., hd, wd) uint8 → (..., H, W), or None when the native path is
    off or ``x`` is not uint8 with two or more axes (the caller then uses
    the numpy mapping)."""
    if _decide() != "on" or x.dtype != np.uint8 or x.ndim < 2:
        return None
    x = np.ascontiguousarray(x)
    lead = x.shape[:-2]
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = np.empty(lead + tuple(out_hw), np.uint8)
    rc = _lib.svos_nearest_u8(x.ctypes.data, n, x.shape[-2], x.shape[-1], out.ctypes.data,
                              int(out_hw[0]), int(out_hw[1]), os.cpu_count() or 1)
    return out if rc == 0 else None
