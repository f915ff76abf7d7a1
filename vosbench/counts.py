"""Frozen counts of work: the operations and bytes of each measured op,
computed from shapes and the sampling schedule alone, and the published
peaks of one NVIDIA H100 SXM.

Nothing here reads the program: the convolutions are counted from the
architecture tables below (the reference's stride-8 ResNets), the affinity
op from the memory-bank schedule of :mod:`vosbench.reference.schedule`. A
kernel that replaces another is charged the same work.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
# 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# exps of the MUFU pipe: 16 a clock per SM x 132 SMs x 1980 MHz
PEAK_EXPS = 16 * 132 * 1980e6
# a pair whose Gaussian prior is below exp(-36) skips its label product
PRIOR_CUTOFF = 36.0

# (blocks per stage, stage widths) of the bottleneck ResNets; stage strides
# (1, 2, 1, 1): overall stride 8
ARCH = {
    "resnet50": ((3, 4, 6, 3), (64, 128, 256, 256)),
    "facebook": ((3, 4, 6, 3), (64, 128, 256, 512)),
}
STAGE_STRIDES = (1, 2, 1, 1)
EXPANSION = 4


def conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def feature_hw(h: int, w: int) -> Tuple[int, int]:
    """Stride-8 grid of an (h, w) frame: conv1 (7, stride 2), the max-pool
    (3, stride 2), layer2's strided 3x3."""
    return tuple(conv_out(conv_out(conv_out(n, 7, 2), 3, 2), 3, 2) for n in (h, w))


def vosnet_convs(arch: str, h: int, w: int) -> List[Tuple[str, int, int, int, int, int]]:
    """Every convolution of one VOSNet forward of an (h, w) frame, in
    order: (name, cin, cout, k, out_h, out_w)."""
    layers, planes = ARCH[arch]
    oh, ow = conv_out(h, 7, 2), conv_out(w, 7, 2)
    convs = [("stem", 3, 64, 7, oh, ow)]
    oh, ow = conv_out(oh, 3, 2), conv_out(ow, 3, 2)
    inplanes = 64
    for stage, (width, blocks, stride) in enumerate(zip(planes, layers, STAGE_STRIDES), start=1):
        for b in range(blocks):
            s = stride if b == 0 else 1
            name = f"layer{stage}_{b}"
            convs.append((f"{name}/conv1", inplanes, width, 1, oh, ow))
            bh, bw = conv_out(oh, 3, s), conv_out(ow, 3, s)
            convs.append((f"{name}/conv2", width, width, 3, bh, bw))
            convs.append((f"{name}/conv3", width, width * EXPANSION, 1, bh, bw))
            if b == 0 and (s != 1 or inplanes != width * EXPANSION):
                convs.append((f"{name}/downsample", inplanes, width * EXPANSION, 1, bh, bw))
            oh, ow, inplanes = bh, bw, width * EXPANSION
    if arch == "facebook":
        convs.append(("head0", inplanes, 1024, 1, oh, ow))
        inplanes = 1024
    convs.append(("head", inplanes, 256, 1, oh, ow))
    return convs


def conv_flops(arch: str, h: int, w: int) -> float:
    """Multiply-adds x 2 of every convolution of one (h, w) frame."""
    return float(sum(2.0 * oh * ow * cin * cout * k * k for _, cin, cout, k, oh, ow in vosnet_convs(arch, h, w)))


def affinity_work(k: int, p: int, wd: int, c: int, d: int, inv_sigma2: Sequence[float]) -> Tuple[float, float, float]:
    """One propagation of a P-pixel frame over K slots, the work its data
    needs: the similarity (2·K·P²·C), the label product (2·D a pair) where
    the prior is not below exp(-36) (every pair in probability mode,
    inverse sigma² 0), and the exps (one a pair, and the prior's row and
    column factors, 2·P − 1 + 2·wd − 1 for each slot that has one). Rows
    are ``index / wd``, fractional. Returns (similarity ops, label ops,
    exps)."""
    # float32 rows, as the kernel builds them
    y = np.arange(p, dtype=np.float32) / np.float32(wd)
    dy2 = np.square(y[:, None] - y[None, :]) if p <= 8192 else None
    near_of: Dict[float, int] = {}
    for s in inv_sigma2:
        s = float(s)
        if s in near_of:
            continue
        if s == 0.0:
            near_of[s] = p * p
        elif dy2 is not None:
            near_of[s] = int((dy2 * np.float32(s) < PRIOR_CUTOFF).sum())
        else:  # large grids: count the rows within reach of each row, by sorted search
            reach = np.float32(np.sqrt(PRIOR_CUTOFF / s))
            near_of[s] = int((np.searchsorted(y, y + reach, side="left")
                              - np.searchsorted(y, y - reach, side="right")).sum())
    near = sum(near_of[float(s)] for s in inv_sigma2)
    exps = k * p * p + sum(2 * p - 1 + 2 * wd - 1 for s in inv_sigma2 if s > 0)
    return 2.0 * k * p * p * c, 2.0 * near * d, float(exps)


def bound_s(terms: Iterable[Tuple[float, float]], nbytes: float, exps: float = 0.0) -> float:
    """Least seconds for the work: the larger of the operations time (the
    sum of ops / rate over ``terms``, or the exps at the MUFU rate) and the
    bytes at the memory rate."""
    t_ops = max(sum(ops / rate for ops, rate in terms), exps / PEAK_EXPS)
    return max(t_ops, nbytes / PEAK_BYTES)


def affinity_call_bound(k_valid: int, lanes: int, p: int, wd: int, c: int, d: int, d_pad: int,
                        inv_sigma2: Sequence[float], elem_bytes: int = 2) -> float:
    """Least seconds of one affinity op call over ``lanes`` lanes: the
    ``k_valid`` valid slots' work at the bf16 rate, its exps at the MUFU
    rate, and each byte read or written once (the slots' features and
    labels, the float32 targets, the float32 scores)."""
    sim, lab, exps = affinity_work(k_valid, p, wd, c, d, inv_sigma2)
    nbytes = lanes * (k_valid * p * (c + d_pad) * elem_bytes + p * c * 4 + d_pad * p * 4)
    return bound_s([(lanes * (sim + lab), PEAK_BF16_FLOPS)], nbytes, lanes * exps)


def bottleneck_call(n: int, h: int, w: int, c: int, c4: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one fused bottleneck block over (n, h, w, c)
    activations: its three convolutions, the input and output once, the
    weights once."""
    flops = 2.0 * n * h * w * (c * c4 + 9 * c4 * c4 + c4 * c)
    nbytes = 2.0 * n * h * w * c * elem_bytes + (c * c4 + 9 * c4 * c4 + c4 * c) * elem_bytes
    return flops, nbytes


def bottleneck_call_bound(n: int, h: int, w: int, c: int, c4: int) -> float:
    flops, nbytes = bottleneck_call(n, h, w, c, c4)
    return bound_s([(flops, PEAK_BF16_FLOPS)], nbytes)


def propagation_flops(t: int, p: int, wd: int, c: int, d: int, ref_num: int, frame_range: int,
                      sigma_1: float, sigma_2: float, cache: Dict = None) -> float:
    """Tensor operations of the affinity op at frame ``t`` of a video: its
    valid slots' similarity and label product."""
    from vosbench.reference.schedule import sample_frames, slot_inv_sigma2

    idx, valid, dense = sample_frames(t, frame_range, ref_num)
    inv = tuple(slot_inv_sigma2(valid, dense, sigma_1, sigma_2)[valid].tolist())
    key = (inv, p, wd)
    if cache is not None and key in cache:
        return cache[key]
    sim, lab, _ = affinity_work(len(inv), p, wd, c, d, inv)
    if cache is not None:
        cache[key] = sim + lab
    return sim + lab


def train_step_flops(arch: str, bs: int, frames: int, crop: int, c: int = 256, d: int = 22) -> float:
    """Operations of one cross-entropy train step: the forward's
    convolutions over bs x frames crops and the loss's two products
    (2·B·R·P²·C and 2·B·R·P²·D, R = frames − 1 references), all three times
    (a backward is two products of the forward's size)."""
    hd, wd = feature_hw(crop, crop)
    p, r = hd * wd, frames - 1
    return 3.0 * (bs * frames * conv_flops(arch, crop, crop) + 2.0 * bs * r * p * p * (c + d))
