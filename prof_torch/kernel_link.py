"""Does ``torch.profiler`` link the port's own kernels to the range that
launched them? Each way of launching is tried in a process of its own:

* ``static``: the libraries as ``ops/_build.py`` builds them (``nvcc``'s
  default static CUDA runtime, ``<<<...>>>`` launches);
* ``shared``: the same sources built with ``-cudart shared``, so their
  launches go through the process's shared CUDA runtime, the one PyTorch
  loaded;
* ``driver``: a small kernel compiled to a cubin and launched through the
  driver API (``cuLaunchKernel``), as Triton launches.

In each, a small kernel (the first two ways: a ``<<<...>>>`` launch from a
library of its own) runs three times inside a ``record_function`` user
range (``probe.tiny``) and three times inside an op's range
(``torch._C._profiler._RecordFunctionFast``, ``probe.tiny_op``), and, for
``static`` and ``shared``, one chunk of the 480p resnet50 engine (the
bottleneck, bank sweep and combine kernels, inside the engine's own
``svos.*`` spans) inside ``probe.chunk``, under the profiler. The process
prints one JSON line: per kernel name, its device ops and how many of them
the profiler hung on a host op or range, and which ones, and the user
ranges the profiler copied to the card's row (``gpu_user_annotation``).

    python3 prof_torch/kernel_link.py

runs the three ways in turn and prints their lines (one NVIDIA card).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHARED = ("-cudart", "shared", "-Xlinker", "-rpath=/usr/local/cuda/lib64")
TINY = r"""
extern "C" __global__ void tiny_kernel(float* x, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) x[i] = x[i] * 2.0f + 1.0f;
}
extern "C" int tiny_launch(float* x, int n, void* stream) {
    tiny_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, n);
    return (int)cudaGetLastError();
}
"""


def links(prof, names):
    """Per name pattern: device ops, and the host events they hang on."""
    out = {n: {"device_ops": 0, "linked": 0, "parents": Counter()} for n in names}
    for e in prof.events():
        dev_type = str(getattr(e, "device_type", "")).rsplit(".", 1)[-1]
        if dev_type != "CPU":
            for n in names:
                if n in e.name:
                    out[n]["device_ops"] += 1
            continue
        for k in getattr(e, "kernels", None) or ():
            for n in names:
                if n in k.name:
                    out[n]["linked"] += 1
                    out[n]["parents"][e.name] += 1
    return {n: dict(v, parents=dict(v["parents"])) for n, v in out.items()}


def tiny_library(work: Path, flags) -> ctypes.CDLL:
    from semi_supervised_vos_tpu_torch.ops._build import nvcc

    src = work / "tiny.cu"
    src.write_text(TINY)
    lib = work / "libtiny.so"
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler", "-fPIC",
                    *flags, "-o", str(lib), str(src)], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def tiny_driver(work: Path):
    """The small kernel as a cubin, launched by ``cuLaunchKernel``."""
    from semi_supervised_vos_tpu_torch.ops._build import nvcc

    src = work / "tiny_driver.cu"
    src.write_text(TINY.split('extern "C" int')[0])
    cubin = work / "tiny.cubin"
    subprocess.run([nvcc(), "-cubin", "-arch=sm_90a", "-o", str(cubin), str(src)], check=True,
                   capture_output=True, timeout=300)
    cuda = ctypes.CDLL("libcuda.so.1")
    mod, fn = ctypes.c_void_p(), ctypes.c_void_p()
    assert cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()) == 0
    assert cuda.cuModuleGetFunction(ctypes.byref(fn), mod, b"tiny_kernel") == 0
    cuda.cuLaunchKernel.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 + [ctypes.c_void_p] * 3

    def launch(x, stream):
        ptr, n = ctypes.c_void_p(x.data_ptr()), ctypes.c_int(x.numel())
        args = (ctypes.c_void_p * 2)(ctypes.addressof(ptr), ctypes.addressof(n))
        return cuda.cuLaunchKernel(fn, (x.numel() + 255) // 256, 1, 1, 256, 1, 1, 0, stream, args, None)

    return launch


def engine_chunk():
    """One 8-frame chunk of the 480p resnet50 engine, started and warmed."""
    import numpy as np
    import torch

    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    engine = PropagationEngine(VOSNet("resnet50"), (480, 854), EngineConfig(), "cuda")
    frames = rng.integers(0, 256, (9, 480, 854, 3), dtype=np.uint8)
    label = np.zeros((480, 854), np.int64)
    label[100:300, 200:500] = 1
    state = engine.start_video(frames[0], label)
    engine.step_chunk_small(frames[1:], state, 1)
    torch.cuda.synchronize()
    return lambda: engine.step_chunk_small(frames[1:], state, 1)


def child(mode: str) -> dict:
    import torch
    from torch._C._profiler import _RecordFunctionFast

    from semi_supervised_vos_tpu_torch.ops import _build

    if mode == "shared":
        _build.NVCC_FLAGS = tuple(_build.NVCC_FLAGS) + SHARED
    x = torch.zeros(1 << 20, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    work = Path(tempfile.mkdtemp(prefix="kernel_link-"))
    if mode == "driver":
        launch = tiny_driver(work)
    else:
        lib = tiny_library(work, SHARED if mode == "shared" else ())
        lib.tiny_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        launch = lambda t, s: lib.tiny_launch(t.data_ptr(), t.numel(), s)  # noqa: E731
    assert launch(x, stream) == 0
    chunk = engine_chunk() if mode != "driver" else None
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            with torch.profiler.record_function("probe.tiny"):
                assert launch(x, stream) == 0
        for _ in range(3):
            with _RecordFunctionFast("probe.tiny_op"):
                assert launch(x, stream) == 0
        if chunk is not None:
            with torch.profiler.record_function("probe.chunk"):
                chunk()
        torch.cuda.synchronize()
    names = ["tiny_kernel", "bottleneck_kernel<", "affinity_bank_kernel<", "affinity_combine_kernel"]
    found = links(prof, names)
    # what the exported trace holds for the tiny kernel: its correlation
    # id, and host-side runtime or driver calls with the same id
    trace = work / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    corr = defaultdict(list)
    for e in events:
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            corr[c].append((e.get("cat"), e.get("name")))
    tiny = [corr[(e.get("args") or {}).get("correlation")] for e in events
            if e.get("cat") == "kernel" and "tiny_kernel" in str(e.get("name"))]
    copied = sorted({e.get("name") for e in events if e.get("cat") == "gpu_user_annotation"})
    return {"mode": mode, "torch": torch.__version__, "cuda": torch.version.cuda, "links": found,
            "tiny_correlated": tiny[:3], "gpu_user_annotation": copied}


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(child(sys.argv[1])), flush=True)
        return 0
    rc = 0
    for mode in ("static", "shared", "driver"):
        r = subprocess.run([sys.executable, __file__, mode], cwd=ROOT, capture_output=True, text=True, timeout=900)
        print(r.stdout.strip().splitlines()[-1] if r.returncode == 0 and r.stdout.strip()
              else f"{mode}: exit {r.returncode}\n{r.stderr[-3000:]}", flush=True)
        rc |= r.returncode
    return rc


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
