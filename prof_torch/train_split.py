"""Where the port's training time goes on the card: the full-width train
step by kernel family, and the train CLI's wall time against the time the
card was busy.

    python3 prof_torch/train_split.py

(1) resnet50 at bs 16 x 10 frames x 256^2 (the train CLI's defaults) on one
batch of ``chip_smoke.py``'s 480p training tree, at PyTorch's default
precision: cross-entropy, then the skeleton miner (pipelined), three steps
to warm up and five under ``torch.profiler``; the card's kernel time a step,
summed by family as the kernel names tell them apart (convolutions, batch
norm, the loss's matmuls, softmax and reductions, elementwise, the
optimizer, copies). (2) ``train`` through the CLI (2 epochs, ``--early-stop``)
under the profiler: wall time, the card's busy time (the union of its kernel
intervals) and the idle share; the profiler slows the host, so the idle
share is an upper bound. Prints a line per part and a JSON line last. Needs
one NVIDIA card.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = 5

# first match wins: cuDNN's convolution kernels are implicit GEMMs by name,
# and it runs 1x1 convolutions as plain TF32 GEMMs; TF32 matmuls are off
# (PyTorch's default), so every tf32 kernel is a convolution and the other
# GEMMs are the loss's float32 products. Layout transposes are copies.
FAMILIES = [
    ("batch norm", re.compile(r"batch_?norm|bn_fw|bn_bw|welford", re.I)),
    ("convolution", re.compile(r"fprop|dgrad|wgrad|implicit|conv(?!ert)|winograd|tf32", re.I)),
    ("copies", re.compile(r"nchwtonhwc|nhwctonchw|transpose|copy|memcpy|memset|cat|gather|scatter|index", re.I)),
    ("optimizer", re.compile(r"multi_tensor|foreach|sgd", re.I)),
    ("loss matmul", re.compile(r"gemm|cutlass|cublas", re.I)),
    ("softmax, reductions", re.compile(r"softmax|reduce|argm|norm", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled", re.I)),
]


def family(name: str) -> str:
    return next((fam for fam, pattern in FAMILIES if pattern.search(name)), "other")


def kernel_intervals(torch, prof):
    """(name, start us, end us) of every kernel the card ran."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def step_split(torch, dev, work: Path, label: str, loss: str, miner):
    import chip_smoke as cs
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net, make_spec
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import iterate_batches, make_geometry_fn, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    tree = work / "train"
    ds = TrainDataset(tree / "JPEGImages" / "480p", tree / "Annotations" / "480p", cropping=cs.TRAIN_CROP,
                      frame_num=cs.TRAIN_FRAMES)
    imgs, anns = next(iterate_batches(ds, cs.TRAIN_BS, num_workers=8))
    net = build_train_net("resnet50", dev).train()
    spec = make_spec(loss, miner or "default", 0.1, 1.0)
    step = make_train_step(net, spec, make_optimizer(net.parameters()))
    geometry_fn = make_geometry_fn(spec, davis_centroids(), dev)
    extra = () if geometry_fn is None else (tuple(torch.as_tensor(g, device=dev) for g in geometry_fn(anns)),)
    args = (torch.as_tensor(imgs, device=dev), torch.as_tensor(anns, device=dev),
            torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev),
            torch.Generator(device=dev).manual_seed(0), *extra)
    for _ in range(3):
        step(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_intervals(torch, prof)
    by_family = collections.defaultdict(float)
    for name, s, e in kernels:
        by_family[family(name)] += (e - s) / 1e3 / STEPS
    total = sum(by_family.values())
    split = dict(sorted(by_family.items(), key=lambda kv: -kv[1]))
    print(f"{label} step: {wall / STEPS * 1e3:.3f} ms wall under the profiler, {total:.3f} ms of kernels, "
          f"{len(kernels) // STEPS} kernels a step: "
          + ", ".join(f"{k} {v:.3f} ms ({v / total:.1%})" for k, v in split.items()), flush=True)
    top = collections.defaultdict(float)
    for name, s, e in kernels:
        top[name[:90]] += (e - s) / 1e3 / STEPS
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:8.3f} ms  {name}", flush=True)
    del net, step
    torch.cuda.empty_cache()
    return dict(wall_ms=wall / STEPS * 1e3, kernel_ms=total, kernels_per_step=len(kernels) // STEPS, by_family=split)


def cli_split(torch, work: Path):
    from semi_supervised_vos_tpu_torch.__main__ import cli

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    tree = work / "train"
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cli(["train", "-t", str(tree), "-v", str(tree), "-m", str(work / "ckpts"), "--epochs", "2", "--early-stop"],
            standalone_mode=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_us(kernel_intervals(torch, prof)) / 1e6
    print(f"train CLI under the profiler: {wall:.3f} s wall, card busy {busy:.3f} s, idle share {1 - busy / wall:.4f}",
          flush=True)
    return dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ["SVOS_ZOO"] = "0"  # random init, no download
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        cs.make_davis_tree(work / "train", cs.TRAIN_VIDEOS, (cs.H480, cs.W480), seed=5)
        res = {"cross_entropy": step_split(torch, dev, work, "cross_entropy", "cross_entropy", None),
               "triplet skeleton": step_split(torch, dev, work, "triplet skeleton", "triplet", "skeleton"),
               "cli": cli_split(torch, work)}
    print(card)
    print(json.dumps({"train_split": res, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
