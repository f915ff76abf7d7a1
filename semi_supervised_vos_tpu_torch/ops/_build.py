"""Build and load the hand-written CUDA kernels and the host libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
root of the checkout, then loaded with ``ctypes``. The library's file name
carries a hash of its source, the shared headers beside it and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. Nothing is built or imported until a
kernel is first needed (or :func:`build` is called), so the CPU-only tests
import every module without a CUDA toolkit.

The two host libraries, ``csrc/host/decode.cpp`` (the JPEG decoder) and
``csrc/host/upsample.cpp`` (the mask upsampler), are compiled the same way
by ``g++`` into ``build/host/`` (:func:`build_host`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
HOST_BUILD_DIR = _PKG.parent / "build" / "host"
KERNELS = ("affinity_bank", "bottleneck", "affinity_bank_f32", "bottleneck_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where kernel ``name``'s library lives: its file name hashes
    ``<name>.cu``, every header (``*.cuh``) beside it and the flags, so an
    edit to a shared header rebuilds every library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, all ``nvcc``
    processes started together. Returns {name: seconds} for those compiled;
    the compiler's output (registers, shared memory, spills) is kept beside
    each library as ``.log``. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output from building ``name`` ('' if not built here)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def build_host(name: str, flags: Iterable[str]) -> Path:
    """Compile ``csrc/host/<name>.cpp`` with ``g++ -shared -fPIC`` and
    ``flags`` (optimisation and link flags) into ``build/host/``, unless it
    is built; the file name hashes the source and the flags. Returns the
    library's path; raises ``OSError`` or ``subprocess.SubprocessError``
    (the compiler's output attached) on failure."""
    flags = list(flags)
    src = CSRC / "host" / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    out = HOST_BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    with _LOCK:
        if not out.exists():
            HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-shared", "-fPIC", "-o", str(tmp), str(src), *flags],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
    return out


def build_failure(err: Exception) -> str:
    """One line saying why :func:`build_host` or loading its library failed:
    the compiler's first error line when it has one."""
    lines = (getattr(err, "stderr", None) or b"").decode(errors="replace").splitlines()
    detail = next((ln.strip() for ln in lines if "error" in ln), lines[-1].strip() if lines else str(err))
    return f"the build or load failed ({type(err).__name__}: {detail})"
