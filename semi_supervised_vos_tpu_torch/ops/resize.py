"""Nearest-neighbour resize with torch ``F.interpolate(mode='nearest')``
index arithmetic: output pixel ``o`` reads input pixel
``min(floor(o * in / out), in - 1)``, computed in exact integer arithmetic.
Channels-last layout ``(..., H, W, C)`` by default, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.utils.profiling import span


def _nearest_indices(out_size: int, in_size: int, device=None) -> torch.Tensor:
    o = torch.arange(out_size, device=device, dtype=torch.int64)
    return torch.clamp((o * in_size) // out_size, max=in_size - 1)


def nearest_resize(
    x: torch.Tensor, out_hw: Tuple[int, int], hw_axes: Tuple[int, int] = (-3, -2)
) -> torch.Tensor:
    """Resize the two spatial axes of ``x`` (a gather, same dtype)."""
    h_ax = hw_axes[0] % x.ndim
    w_ax = hw_axes[1] % x.ndim
    rows = _nearest_indices(out_hw[0], x.shape[h_ax], x.device)
    cols = _nearest_indices(out_hw[1], x.shape[w_ax], x.device)
    return x.index_select(h_ax, rows).index_select(w_ax, cols)


def nearest_resize_host(x, out_hw: Tuple[int, int], hw_axes: Tuple[int, int] = (0, 1)) -> np.ndarray:
    """NumPy twin of :func:`nearest_resize` for host-side mask upsampling
    (the same integer index mapping). A uint8 array with H and W as its
    last two axes (every mask drain's case) goes through the native
    upsampler (``ops/native_upsample.py``) while it is on: the same bytes."""
    with span("drain.upsample"):
        x = np.asarray(x)
        h_ax = hw_axes[0] % x.ndim
        w_ax = hw_axes[1] % x.ndim
        if (h_ax, w_ax) == (x.ndim - 2, x.ndim - 1) and x.dtype == np.uint8:
            from semi_supervised_vos_tpu_torch.ops.native_upsample import nearest_u8

            out = nearest_u8(x, out_hw)
            if out is not None:
                return out
        rows = np.minimum(np.arange(out_hw[0]) * x.shape[h_ax] // out_hw[0], x.shape[h_ax] - 1)
        cols = np.minimum(np.arange(out_hw[1]) * x.shape[w_ax] // out_hw[1], x.shape[w_ax] - 1)
        x = np.take(x, rows, axis=h_ax)
        return np.take(x, cols, axis=w_ax)
