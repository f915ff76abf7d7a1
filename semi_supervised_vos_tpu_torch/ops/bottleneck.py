"""Fused BN-folded bottleneck block: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``semi_supervised_vos_tpu/ops/bottleneck_pallas.py::
bottleneck_block``: one stride-1 bottleneck without a downsample branch in
NHWC, ``relu(x + relu(conv3x3(relu(x·W1+b1)) + b2)·W3 + b3)``, with the
C/4-wide intermediates kept on chip. The kernel is ``csrc/bottleneck.cu``;
see its header for the design and what bounds it. y1 and y2 are rounded to
the activation dtype, as in the JAX kernel.

On a CPU tensor the wrapper runs :func:`bottleneck_block_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """(1, 1, Cin, Cout) or (Cin, Cout) → (Cin, Cout)."""
    return w.reshape(w.shape[-2], w.shape[-1])


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


def bottleneck_block(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """One fused stride-1 bottleneck block without a downsample branch.

    Args:
      x: (N, H, W, C) activations, NHWC (bf16 and contiguous on the card).
      w1: (C, C4) or (1, 1, C, C4) folded 1x1 kernel; b1: (C4,) float32.
      w2: (3, 3, C4, C4) folded 3x3 kernel, HWIO; b2: (C4,) float32.
      w3: (C4, C) or (1, 1, C4, C) folded 1x1 kernel; b3: (C,) float32.

    Returns (N, H, W, C) in x's dtype. On the card, C4 must be 128 or 256
    and C a multiple of 64 (the 11 wide blocks of resnet50 / resnet101).
    """
    dev = x.device
    if dev.type == "cpu":
        return bottleneck_block_plain(x, w1, b1, w2, b2, w3, b3)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    w1, w3 = _as_matrix(w1), _as_matrix(w3)
    n, h, w, c = x.shape
    c4 = w1.shape[-1]
    shapes = {
        "x": (x, (n, h, w, c), torch.bfloat16),
        "w1": (w1, (c, c4), torch.bfloat16),
        "b1": (b1, (c4,), torch.float32),
        "w2": (w2, (3, 3, c4, c4), torch.bfloat16),
        "b2": (b2, (c4,), torch.float32),
        "w3": (w3, (c4, c), torch.bfloat16),
        "b3": (b3, (c,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    if c4 not in (128, 256) or c % 64:
        raise ValueError(f"kernel takes C4 in (128, 256) and C % 64 == 0, got C={c} C4={c4}")
    out = torch.empty_like(x)
    from semi_supervised_vos_tpu_torch.ops._build import load

    fn = load("bottleneck").bottleneck_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), out.data_ptr(), n, h, w, c, c4,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bottleneck kernel launch failed: cudaError {err}")
    bottleneck_block.launches += 1
    return out


bottleneck_block.launches = 0
