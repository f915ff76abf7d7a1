"""Measurement helpers: the card's identity, CUDA-event timing, the
published H100 peaks, the least time a piece of work can take, and the
operation counts of the two hot ops (the convolutions of a VOSNet forward
and one propagation step of the affinity op).

``chip_smoke.py``, ``prof_torch/`` and the two benches
(:mod:`semi_supervised_vos_tpu_torch.bench`,
:mod:`semi_supervised_vos_tpu_torch.bench_train`) share them. Nothing here
times anything on the CPU: :func:`time_ms` records CUDA events.
"""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict, Optional, Sequence

import torch

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
# 700 W power limit
PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores
PEAK_TF32_FLOPS = 495e12  # tf32 tensor cores (3xTF32: three products)
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
MUFU_EXP_PER_CLOCK_PER_SM = 16  # ex2 results per clock per SM on compute capability 9.0
# a pair whose Gaussian prior is below exp(-36) skips its label product
PRIOR_CUTOFF = 36.0


def card_line() -> str:
    """The first card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(device) -> Dict[str, object]:
    """What a measurement ran on: the card's name, power limit (from
    nvidia-smi), compute capability and the card count; on the CPU the
    platform and nulls."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "name": None, "power_limit": None, "capability": None,
                "count": torch.cuda.device_count()}
    name, _, power = card_line().partition(",")
    cap = torch.cuda.get_device_capability(0)
    return {"platform": "gpu", "name": name.strip(), "power_limit": power.strip(),
            "capability": f"{cap[0]}.{cap[1]}", "count": torch.cuda.device_count()}


class Timing(float):
    """Median ms of a timing, carrying the spread of its reps (``lo`` and
    ``hi``: the 10th and 90th percentiles)."""

    def __new__(cls, times):
        times = sorted(times)
        self = super().__new__(cls, statistics.median(times))
        pick = lambda f: times[min(len(times) - 1, int(round(f * (len(times) - 1))))]  # noqa: E731
        self.lo, self.hi = pick(0.1), pick(0.9)
        return self

    def __format__(self, spec):
        return f"{float(self):{spec}} [p10 {self.lo:{spec}}, p90 {self.hi:{spec}}]"


def time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> Timing:
    """Median of ``reps`` CUDA-event timings of ``fn``, with their p10-p90
    spread."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(times)


def timing_keys(prefix: str, t: Timing) -> dict:
    return {prefix: float(t), f"{prefix}_p10": t.lo, f"{prefix}_p90": t.hi}


def mufu_exp_rate() -> float:
    """exps per second of the card's MUFU pipe: MUFU_EXP_PER_CLOCK_PER_SM x
    SMs x the maximum SM clock that nvidia-smi reports."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return MUFU_EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def bound(tensor_ops, nbytes: float, exps: float = 0.0, peak: float = PEAK_BF16_FLOPS):
    """Least time (ms) for the work, and what sets it: the largest of the
    operations at their peak rate (``peak``: bf16 tensor cores, or
    PEAK_F32_FLOPS / PEAK_TF32_FLOPS for float32 work; ``tensor_ops`` may
    also be a list of (operations, rate) pairs, whose times add), the exps
    at the MUFU pipe's rate (both "operations") and the bytes at the memory
    rate."""
    terms = tensor_ops if isinstance(tensor_ops, (list, tuple)) else [(tensor_ops, peak)]
    t_tensor = sum(ops / rate for ops, rate in terms) * 1e3
    t_exp = exps / mufu_exp_rate() * 1e3 if exps else 0.0
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(t_tensor, t_exp)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_flops(net: torch.nn.Module, x: torch.Tensor) -> float:
    """Multiply-adds x 2 of every convolution in one forward of ``x``, and
    of a ViT's linear layers and attention products (q kᵀ and the weights
    times v, 4·T²·C over (N, T, C) tokens; ``models/vit.py``), counted from
    the output shapes, so a network and input on the ``meta`` device count
    without computing."""
    from semi_supervised_vos_tpu_torch.models.vit import Attention

    total = []

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Linear):
            total.append(2.0 * out.numel() * m.in_features)
        elif isinstance(m, Attention):
            n, t, c = inp[0].shape
            total.append(4.0 * n * t * t * c)
        else:
            total.append(2.0 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1])

    kinds = (torch.nn.Conv2d, torch.nn.Linear, Attention)
    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            net.eval()(x)
    finally:
        for h in handles:
            h.remove()
    return sum(total)


def vosnet_frame_flops(arch: str, hw: Sequence[int]) -> float:
    """:func:`conv_flops` of one (H, W) frame through the network ``arch``
    names (``models/vos_net.py::build_vos_net``), counted on the ``meta``
    device; a network that counts its own (``frame_flops``: SAM 2's Hiera,
    whose layers run as functions of its weights) gives that."""
    from semi_supervised_vos_tpu_torch.models.vos_net import build_vos_net

    with torch.device("meta"):
        net = build_vos_net(arch)
        if hasattr(net, "frame_flops"):
            return net.frame_flops(*hw)
        return conv_flops(net, torch.empty(1, 3, *hw))


def affinity_work(k: int, p: int, wd: int, c: int, d: int, inv_sigma2: Sequence[float], device=None):
    """The operations of one propagation of a P-pixel frame over K slots,
    counting the work this frame's data needs: the similarity (2·K·P²·C
    tensor operations), the label product (2·D a pair) where the prior is
    not below exp(-36), which is every pair in probability mode (inverse
    sigma² 0), and the exps (the softmax's, one a pair, and the prior
    factored into a row and a column factor, 2·P − 1 + 2·wd − 1 for each
    slot that has one). Pixel rows are ``index / wd``, fractional, as the
    kernel builds them. Returns (similarity ops, label ops, exps)."""
    y = torch.arange(p, device=device, dtype=torch.float32) / wd
    dy2 = (y[:, None] - y[None, :]) ** 2
    near_of = {}
    for s in inv_sigma2:
        if float(s) not in near_of:
            near_of[float(s)] = int((dy2 * float(s) < PRIOR_CUTOFF).sum())
    near = sum(near_of[float(s)] for s in inv_sigma2)
    exps = k * p * p + sum(2 * p - 1 + 2 * wd - 1 for s in inv_sigma2 if s > 0)
    return 2.0 * k * p * p * c, 2.0 * near * d, exps


def affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes, peak: float = PEAK_BF16_FLOPS, products: int = 1):
    """Least time (ms) of one propagation (:func:`affinity_work`) moving
    ``nbytes``. With ``products`` 3 (float32 accuracy on tf32 tensor cores,
    ``peak`` PEAK_TF32_FLOPS) the similarity counts three times at ``peak``
    and the label product twice (bf16 hi and lo) at the bf16 rate."""
    sim, lab, exps = affinity_work(k, p, wd, c, d, inv_sigma2, dev)
    terms = [(sim + lab, peak)] if products == 1 else [(products * sim, peak), (2 * lab, PEAK_BF16_FLOPS)]
    return bound(terms, nbytes, exps)


def propagation_flops_per_frame(cfg, hd: int, wd: int, frames: int, device=None) -> float:
    """Tensor operations (similarity and label product, :func:`affinity_work`)
    of the affinity op per propagated frame, averaged over frames 1 ..
    ``frames`` of the engine's sampling schedule: every frame runs all
    ``cfg.ref_num`` slots, each with its own prior."""
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops.affinity import slot_table

    p = hd * wd
    sims = {}
    total = 0.0
    for t in range(1, frames + 1):
        idx, valid, dense = sample_frames(t, cfg.frame_range, cfg.ref_num, cfg.continuous_frame)
        _, inv_sigma2, _ = slot_table(idx, valid, dense, cfg.sigma_1, cfg.sigma_2, not cfg.probability_propagation)
        key = tuple(inv_sigma2.tolist())
        if key not in sims:
            sim, lab, _ = affinity_work(len(idx), p, wd, cfg.feature_dim, cfg.num_classes, inv_sigma2, device)
            sims[key] = sim + lab
        total += sims[key]
    return total / frames


def kernel_launches() -> Dict[str, int]:
    """Every kernel's launch count: the bf16 bank kernel, kernel 3 (on the
    same source), the bf16 bottleneck and the two float32 variants."""
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    return {"affinity_bank": aff.affinity_from_bank_batched.launches,
            "affinity_propagate": aff.affinity_propagate_fused.launches, "bottleneck": bottleneck_block.launches,
            "affinity_bank_f32": aff.affinity_from_bank_batched.launches_f32,
            "bottleneck_f32": bottleneck_block.launches_f32}


def share_of_peak(value: Optional[float], flops: float, peak: float = PEAK_BF16_FLOPS) -> Optional[float]:
    """``value`` (per second) x ``flops`` over ``peak``; None without a
    value."""
    return None if value is None else value * flops / peak
