"""ctypes bridge to the threaded JPEG decoder (``csrc/host/decode.cpp``):
the port's counterpart of ``semi_supervised_vos_tpu/data/native_decode.py``,
with the same API and semantics.

Compiled with ``g++`` at first use into ``build/host/``
(``ops/_build.py::build_host``), linked against Pillow's bundled
libjpeg-turbo when there is one, else ``-ljpeg``, so the decoded bytes are
PIL's. At first use a probe image is decoded by both paths, whole and as a
row band, and compared byte for byte: libjpeg's IDCT output depends on the
library build, and the decoded pixels feed the numerics contract, so a
failed build or any mismatch keeps PIL for the process, with one log line
saying why.

**Opt-in** through ``SVOS_NATIVE_DECODE=1``: the thread pool pays off on
hosts with several cores; on one core PIL's loop is as fast.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from semi_supervised_vos_tpu_torch.utils.logging import logger

_lib = None  # ctypes handle once loaded
_state: Optional[str] = None  # None = undecided, "on", "off"
reason: str = ""  # why the decoder is off ("" while on or undecided)


def _turbo_link_args() -> List[str]:
    """Link flags: Pillow's bundled libjpeg-turbo (the bytes PIL decodes),
    else the system's ``-ljpeg``."""
    try:
        import PIL

        libs = Path(PIL.__file__).parent.parent / "pillow.libs"
        for so in sorted(libs.glob("libjpeg-*.so*")):
            return [f"-L{libs}", f"-l:{so.name}", f"-Wl,-rpath,{libs}"]
    except Exception:
        pass
    return ["-ljpeg"]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from semi_supervised_vos_tpu_torch.ops._build import build_host

    lib = ctypes.CDLL(str(build_host("decode", ["-O2", *_turbo_link_args(), "-lpthread"])))
    lib.svos_jpeg_shape.restype = ctypes.c_int
    lib.svos_jpeg_shape.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.svos_jpeg_decode_batch.restype = ctypes.c_int
    lib.svos_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.svos_jpeg_decode_rows.restype = ctypes.c_int
    lib.svos_jpeg_decode_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    return lib


def _decode_batch_raw(blobs: Sequence[bytes], h: int, w: int, threads: int) -> np.ndarray:
    lib = _load()
    n = len(blobs)
    out = np.empty((n, h, w, 3), np.uint8)
    bufs = (ctypes.c_char_p * n)(*blobs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    failures = lib.svos_jpeg_decode_batch(bufs, lens, n, out.ctypes.data_as(ctypes.c_void_p), h, w, threads)
    if failures:
        raise RuntimeError(f"native decode: {failures}/{n} images failed")
    return out


def _decode_rows_raw(blob: bytes, h: int, w: int, y0: int, nrows: int) -> np.ndarray:
    out = np.empty((nrows, w, 3), np.uint8)
    rc = _load().svos_jpeg_decode_rows(blob, len(blob), out.ctypes.data_as(ctypes.c_void_p), h, w, y0, nrows)
    if rc:
        raise ValueError(f"native row decode failed (rc={rc})")
    return out


def _self_check() -> bool:
    """The native bytes equal PIL's on a probe image: the whole decode and a
    row band (the training crop's path)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=92)
    blob = buf.getvalue()
    pil = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    if not (_decode_batch_raw([blob], 48, 64, 1)[0] == pil).all():
        return False
    return bool((_decode_rows_raw(blob, 48, 64, 13, 21) == pil[13:34]).all())


def available() -> bool:
    """Build and check once per process (``SVOS_NATIVE_DECODE=1`` only)."""
    global _state, reason
    if _state is None:
        if os.environ.get("SVOS_NATIVE_DECODE", "0") != "1":
            _state, reason = "off", "SVOS_NATIVE_DECODE is not 1"
        else:
            from semi_supervised_vos_tpu_torch.ops._build import build_failure

            try:
                ok = _self_check()
                reason = "" if ok else "its bytes differ from PIL's"
            except (OSError, subprocess.SubprocessError) as err:
                ok, reason = False, build_failure(err)
            except (RuntimeError, ValueError) as err:
                ok, reason = False, f"the probe decode failed ({err})"
            if not ok:
                logger.info(f"native JPEG decoder off: {reason}; using PIL")
            _state = "on" if ok else "off"
    return _state == "on"


def jpeg_shape(blob: bytes):
    """(H, W) from the JPEG header; ``ValueError`` if it does not decode."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _load().svos_jpeg_shape(blob, len(blob), ctypes.byref(h), ctypes.byref(w))
    if rc:
        raise ValueError(f"not a decodable JPEG (rc={rc})")
    return h.value, w.value


def decode_jpeg_batch(blobs: Sequence[bytes], threads: int = 0) -> np.ndarray:
    """Same-sized RGB JPEGs to (N, H, W, 3) uint8 on a thread pool (0 = one
    thread a core, at most 16)."""
    assert available()
    h, w = jpeg_shape(blobs[0])
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 16)
    return _decode_batch_raw(blobs, h, w, threads)


def decode_jpeg(blob: bytes) -> np.ndarray:
    """One image to (H, W, 3) uint8."""
    assert available()
    h, w = jpeg_shape(blob)
    return _decode_batch_raw([blob], h, w, 1)[0]


def decode_jpeg_rows(blob: bytes, y0: int, nrows: int) -> np.ndarray:
    """Rows [y0, y0 + nrows) only, equal to the same rows of a whole
    decode: libjpeg-turbo skips the IDCT above the band and never reads
    below it (the training crop's path)."""
    assert available()
    h, w = jpeg_shape(blob)
    return _decode_rows_raw(blob, h, w, y0, nrows)
