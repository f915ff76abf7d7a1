"""Label encoding: one-hot along a trailing class axis, and the standard
DAVIS/PASCAL palette (reference ``src/utils/utils.py:59-68``)."""

from __future__ import annotations

import numpy as np
import torch


def index_to_onehot(idx: torch.Tensor, d: int, dtype=torch.float32) -> torch.Tensor:
    """(...,) integer class indices → (..., d) one-hot."""
    classes = torch.arange(d, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).to(dtype)


def davis_palette(n: int = 256) -> np.ndarray:
    """Standard DAVIS/PASCAL-VOC colour palette, (n, 3) uint8 (bit-reversal
    generator)."""
    palette = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        c = i
        r = g = b = 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        palette[i] = (r, g, b)
    return palette
