"""Fused BN-folded bottleneck block: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``semi_supervised_vos_tpu/ops/bottleneck_pallas.py::
bottleneck_block``: one stride-1 bottleneck without a downsample branch in
NHWC, ``relu(x + relu(conv3x3(relu(x·W1+b1)) + b2)·W3 + b3)``, with the
C/4-wide intermediates kept on chip. The kernel is ``csrc/bottleneck.cu``
on bf16 activations and ``csrc/bottleneck_f32.cu`` on float32 ones
(``SVOS_INFER_DTYPE=float32``), counted apart in
``bottleneck_block.launches`` and ``bottleneck_block.launches_f32``; see
their headers for the designs and what bounds them. y1 and y2 are rounded
to the activation dtype, as in the JAX kernel. The float32 kernel computes
float32-accurate products on the tf32 tensor cores (3xTF32): it takes the
weights K-major and pre-split into tf32 ``big`` and ``small`` planes
(:func:`tf32_split_weights`), which a folded table prepares once
(``models/fold.py``) and this wrapper otherwise makes per call.

On a CPU tensor the wrapper runs :func:`bottleneck_block_plain`; on a CUDA
tensor it launches the kernel or raises. :func:`bottleneck_stack` (the JAX
``bottleneck_stack``) runs blocks in sequence, one wrapper call each.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

KERNEL_C4 = (128, 256)  # bottleneck widths the kernels take (the wide blocks of resnet50 / 101, facebook)


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) or (Cin, Cout) → (Cin, Cout)."""
    return w.reshape(w.shape[-2], w.shape[-1])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 → the nearest tf32 value, ties away from zero (the card's
    ``cvt.rna.tf32.f32``), as float32 with the 13 low mantissa bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    # half a tf32 ulp added to the magnitude bits, then truncation
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TF32Planes(NamedTuple):
    """The float32 kernel's weights, K-major, each as (2, ...) float32: plane
    0 ``big = tf32(w)``, plane 1 ``small = tf32(w − big)``."""

    w1: torch.Tensor  # (2, C4, C): (out, in)
    w2: torch.Tensor  # (2, 9, C4, C4): (tap = 3 dy + dx, out, in)
    w3: torch.Tensor  # (2, C, C4): (out, in)


def tf32_split_weights(w1, w2, w3) -> TF32Planes:
    """The pre-split K-major operands of ``csrc/bottleneck_f32.cu`` from the
    folded weights of :func:`bottleneck_block` (w1 (C, C4), w2 HWIO, w3
    (C4, C)), on their device."""

    def split(w):
        w = w.float()
        big = tf32_round(w)
        return torch.stack([big, tf32_round(w - big)]).contiguous()

    c4 = w2.shape[-1]
    return TF32Planes(split(_as_matrix(w1).t()), split(w2.permute(0, 1, 3, 2).reshape(9, c4, c4)),
                      split(_as_matrix(w3).t()))


def bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain PyTorch version of the kernel: float32 math with the kernel's
    rounding points (y1, y2 and the output in ``x.dtype``). Arguments as
    :func:`bottleneck_block`."""
    n, h, w, c = x.shape
    w1, w3 = _as_matrix(w1), _as_matrix(w3)
    c4 = w1.shape[-1]
    dt = x.dtype
    xf = x.float()
    y1 = torch.relu(xf.reshape(-1, c) @ w1.to(dt).float() + b1.float()).to(dt)
    y1 = y1.reshape(n, h, w, c4).permute(0, 3, 1, 2).float()
    k2 = w2.to(dt).float().permute(3, 2, 0, 1)  # HWIO → OIHW
    y2 = torch.relu(F.conv2d(y1, k2, padding=1) + b2.float()[None, :, None, None]).to(dt)
    y2 = y2.permute(0, 2, 3, 1).reshape(-1, c4).float()
    y3 = y2 @ w3.to(dt).float() + b3.float() + xf.reshape(-1, c)
    return torch.relu(y3).to(dt).reshape(n, h, w, c)


def bottleneck_block(x, w1, b1, w2, b2, w3, b3, *, planes: Optional[TF32Planes] = None) -> torch.Tensor:
    """One fused stride-1 bottleneck block without a downsample branch.

    Args:
      x: (N, H, W, C) activations, NHWC (bf16 or float32 and contiguous on
        the card).
      w1: (C, C4) or (1, 1, C, C4) folded 1x1 kernel; b1: (C4,) float32.
      w2: (3, 3, C4, C4) folded 3x3 kernel, HWIO; b2: (C4,) float32.
      w3: (C4, C) or (1, 1, C4, C) folded 1x1 kernel; b3: (C,) float32.
      On the card the kernels are in x's dtype.
      planes: the float32 kernel's operands, ``tf32_split_weights(w1, w2,
        w3)`` prepared once by a folded table; made here when None. Read
        only for float32 activations on the card.

    Returns (N, H, W, C) in x's dtype. On the card, C4 must be 128 or 256
    and C a multiple of 64, of 128 in float32 (the 11 wide blocks of
    resnet50 / resnet101).
    """
    dev = x.device
    if dev.type == "cpu":
        return bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    w1, w3 = _as_matrix(w1), _as_matrix(w3)
    n, h, w, c = x.shape
    c4 = w1.shape[-1]
    f32 = x.dtype == torch.float32
    dt = torch.float32 if f32 else torch.bfloat16
    shapes = {
        "x": (x, (n, h, w, c), dt),
        "w1": (w1, (c, c4), dt),
        "b1": (b1, (c4,), torch.float32),
        "w2": (w2, (3, 3, c4, c4), dt),
        "b2": (b2, (c4,), torch.float32),
        "w3": (w3, (c4, c), dt),
        "b3": (b3, (c,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    c_mult = 128 if f32 else 64
    if c4 not in KERNEL_C4 or c % c_mult:
        raise ValueError(f"kernel takes C4 in {KERNEL_C4} and C % {c_mult} == 0, got C={c} C4={c4}")
    ptrs = (w1.data_ptr(), w2.data_ptr(), w3.data_ptr())
    if f32:
        if planes is None:
            planes = tf32_split_weights(w1, w2, w3)
        for name, t, shape in (("w1", planes.w1, (2, c4, c)), ("w2", planes.w2, (2, 9, c4, c4)),
                               ("w3", planes.w3, (2, c, c4))):
            if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                    or t.data_ptr() % 32):
                raise ValueError(f"planes.{name}: expected contiguous aligned float32 {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs = tuple(t.data_ptr() for t in planes)
    out = torch.empty_like(x)
    from semi_supervised_vos_tpu_torch.ops._build import load

    name = "bottleneck_f32" if f32 else "bottleneck"
    fn = getattr(load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    # the library's host code (shared-memory attribute, SM count, occupancy)
    # and the launch work on the current device: make it x's
    with torch.cuda.device(dev):
        err = fn(
            x.data_ptr(), ptrs[0], b1.data_ptr(), ptrs[1], b2.data_ptr(), ptrs[2], b3.data_ptr(),
            out.data_ptr(), n, h, w, c, c4,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    if f32:
        bottleneck_block.launches_f32 += 1
    else:
        bottleneck_block.launches += 1
    return out


bottleneck_block.launches = 0  # csrc/bottleneck.cu
bottleneck_block.launches_f32 = 0  # csrc/bottleneck_f32.cu


def bottleneck_stack(x, blocks, *, planes: Optional[Sequence[Optional[TF32Planes]]] = None) -> torch.Tensor:
    """A sequence of fused bottleneck blocks: the port of
    ``semi_supervised_vos_tpu/ops/bottleneck_pallas.py::bottleneck_stack``.

    ``blocks`` is a sequence of (w1, b1, w2, b2, w3, b3) tuples, each as
    :func:`bottleneck_block` takes them (a folded table's
    ``layer<S>_<B>/fused``); ``planes`` optionally one :class:`TF32Planes`
    (or None) per block, for float32 activations on the card. Each block is
    one :func:`bottleneck_block` call: one kernel launch, counted as such,
    on the card, its plain version on the CPU. The activation goes through
    device memory between blocks."""
    planes = [None] * len(blocks) if planes is None else list(planes)
    if len(planes) != len(blocks):
        raise ValueError(f"{len(planes)} planes for {len(blocks)} blocks")
    for blk, pl in zip(blocks, planes):
        x = bottleneck_block(x, *blk, planes=pl)
    return x
