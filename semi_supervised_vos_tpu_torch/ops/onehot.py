"""Label encoding: one-hot along a trailing class axis, nearest-centroid RGB
quantisation, the standard DAVIS/PASCAL palette and the 22-colour centroid
table (reference ``src/utils/utils.py:45-68``)."""

from __future__ import annotations

import numpy as np
import torch


def index_to_onehot(idx: torch.Tensor, d: int, dtype=torch.float32) -> torch.Tensor:
    """(...,) integer class indices → (..., d) one-hot."""
    classes = torch.arange(d, device=idx.device, dtype=idx.dtype)
    return (idx[..., None] == classes).to(dtype)


def color_to_class(img: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB values → (...) int64 index of the nearest centroid.

    The squared distances are sums of squared integer differences, exact in
    float32 (no matmul, so TF32 cannot round them); ties resolve to the
    lowest index, as ``argmin`` does in torch and in JAX."""
    diff = img.float()[..., None, :] - centroids.float()
    return torch.argmin((diff * diff).sum(-1), dim=-1)


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


def davis_centroids() -> np.ndarray:
    """The 22-colour class-centroid table, (22, 3) int32: the palette's first
    22 colours with the 192-valued channels stored as 191, as the
    reference's ``annotation_centroids.npy`` holds them (191 vs 192 never
    changes the nearest centroid of a palette colour)."""
    table = davis_palette()[:22].astype(np.int32)
    table[table == 192] = 191
    return table
