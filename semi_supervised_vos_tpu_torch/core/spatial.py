"""Gaussian spatial (motion-prior) weights (reference
``src/model/predict.py:158-175``).

Coordinates are ``(idx / W, idx % W)`` with *true* division, so the "row"
coordinate is fractional (``r + c / W``), exactly as the reference. The
dense ``(P, P)`` matrix is only built by the CPU golden path; the CUDA
affinity kernel recomputes the weight from pixel indices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def spatial_coords(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Per-pixel coordinates ``(idx / w, idx % w)``, shape (h*w, 2)."""
    idx = torch.arange(h * w, device=device, dtype=dtype)
    return torch.stack([idx / float(w), torch.remainder(idx, float(w))], dim=-1)


def spatial_weight(
    shape: Tuple[int, int],
    sigma: float,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Dense ``(H*W, H*W)`` Gaussian weight; ``w[i, j]`` links reference
    pixel *i* to target pixel *j*."""
    h, w = shape
    coords = spatial_coords(h, w, device, dtype)  # (P, 2)
    delta = coords[None, :, :] - coords[:, None, :]
    dist2 = torch.sum(delta * delta, dim=-1)
    return torch.exp(-dist2 / (sigma**2))


def descriptor_weight(array: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """Signed-power descriptor weighting (reference ``predict.py:178-180``,
    unused by any command but part of the public surface)."""
    powed = torch.pow(array, p)
    return torch.sign(powed) * torch.abs(powed)


def temporal_weight(
    frame_1: torch.Tensor,
    frame_2: torch.Tensor,
    sigma: float,
    t_temp: Optional[float] = None,
) -> torch.Tensor:
    """Gaussian weight over per-pixel descriptor differences (reference
    ``predict.py:183-190``, unused by any command but part of the surface)."""
    d = frame_1 - frame_2.T
    if t_temp is not None:
        d = torch.where(d < t_temp, torch.zeros_like(d), d)
    d = torch.sum(torch.pow(d, 2), dim=-1)
    return torch.exp(-d / (sigma**2))
