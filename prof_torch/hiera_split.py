"""Where SAM 2.1 Hiera-L's card path spends a 480p encode
(``models/hiera.py::SamHiera.encode``), on one NVIDIA Hopper card.

    python3 prof_torch/hiera_split.py

With seeded weights (the position tables N(0, 0.02²), the rest at
PyTorch's default) and 480 x 854 frames of noise: a 64-frame encode (the
``sam2-hieral-480p-vb8`` cell's call) timed by CUDA events after a warm-up,
three times; the recorder's spans of one 64-frame encode (device ms a frame
of ``hiera.embed``, ``hiera.window_attention``, ``hiera.global_attention``,
``hiera.mlp``, ``hiera.neck``); and ``torch.profiler`` over one 16-frame
encode: device ms a frame by the op that launched it (self time) and by
kernel. Prints the card's name and power limit first and a JSON line last
(about a minute).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    from semi_supervised_vos_tpu_torch.models.hiera import SamHiera
    from semi_supervised_vos_tpu_torch.utils import profiling
    from semi_supervised_vos_tpu_torch.utils.benchmarking import card_line

    dev = torch.device("cuda")
    print(card_line(), flush=True)
    torch.manual_seed(0)
    net = SamHiera("sam2_hiera_l").to(dev).eval()
    with torch.no_grad():
        net.trunk.pos_embed.normal_(0.0, 0.02)
        net.trunk.pos_embed_window.normal_(0.0, 0.02)
    x = torch.randn((64, 480, 854, 3), device=dev)
    net.encode(x[:8])
    times = []
    for _ in range(3):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        net.encode(x)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    peak = torch.cuda.max_memory_allocated()
    print(f"64-frame encode: {[round(t, 2) for t in times]} ms ({min(times) / 64:.3f} ms a frame); peak "
          f"{peak / 1e9:.3f} GB", flush=True)

    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        net.encode(x)
    spans = {n: r["device_s"] * 1e3 / 64 for n, r in profiling.summary()["spans"].items()}
    counters = profiling.summary()["counters"]
    profiling.reset()
    print("span device ms a frame: " + ", ".join(f"{n} {v:.3f}" for n, v in sorted(spans.items())), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        net.encode(x[:16])
        torch.cuda.synchronize()

    def self_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / 16

    # the host ops, each charged the kernels it launched itself
    ops = sorted(((e.key, self_ms(e), e.count) for e in prof.key_averages()
                  if str(e.device_type).endswith("CPU") and self_ms(e) > 0), key=lambda r: -r[1])
    print("device ms a frame by op (self):", flush=True)
    for key, ms, n in ops[:25]:
        print(f"  {ms:8.3f}  {n:6d}x  {key[:110]}", flush=True)
    total = sum(ms for _, ms, _ in ops)
    print(f"  total {total:.3f} ms a frame", flush=True)
    print(json.dumps({"hiera_split": {"encode64_ms": times, "peak_bytes": peak, "spans_ms_per_frame": spans,
                                      "counters": counters, "ops_ms_per_frame": [[k, ms, n] for k, ms, n in ops[:40]],
                                      "total_ms_per_frame": total}, "card": card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
