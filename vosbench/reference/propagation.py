"""Label propagation in plain float32 PyTorch (Zhang et al.,
arXiv:2004.07193, reference code ``src/model/predict.py:19-71``): the
target's features against the sampled references' (K, P, C), a softmax
over all K·P reference pixels, the spatial prior applied after it (its
denominator unweighted), then the labels' product.

Computed in blocks of target pixels, so that a 1080p frame's (K·P, P)
affinity never lives whole.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vosbench.reference.schedule import slot_inv_sigma2


def nearest_index(out_size: int, in_size: int) -> np.ndarray:
    """Source index of each output index of a nearest resize:
    ``floor(o * in / out)``, clamped."""
    return np.minimum(np.arange(out_size) * in_size // out_size, in_size - 1)


def preimage_index(small: int, full: int) -> np.ndarray:
    """For each index ``i`` of a ``small`` grid, one index of the ``full``
    grid that a nearest upsample from ``small`` reads from ``i``:
    ``ceil(i * full / small)``."""
    return -(-np.arange(small) * full // small)


def downsample_labels(labels_full: np.ndarray, hd: int, wd: int) -> np.ndarray:
    """(..., H, W) class map → (..., hd, wd) by nearest resize."""
    h, w = labels_full.shape[-2:]
    return labels_full[..., nearest_index(hd, h), :][..., nearest_index(wd, w)]


def scores(ref_feats: torch.Tensor, target: torch.Tensor, ref_labels: torch.Tensor, valid, dense,
           hw: Tuple[int, int], sigma_1: float, sigma_2: float, temperature: float = 1.0,
           block: int = 2048) -> torch.Tensor:
    """(K, P, C) references of the valid slots, (P, C) target, (K, P) class
    labels → (D, P) float32 scores, D = ``int(labels.max()) + 1`` at least
    22. ``valid`` / ``dense`` select and weight the K slots as the schedule
    gives them (only valid slots are passed)."""
    hd, wd = hw
    p = hd * wd
    k = ref_feats.shape[0]
    dev = target.device
    inv_s = torch.as_tensor(slot_inv_sigma2(valid, dense, sigma_1, sigma_2)[np.asarray(valid)], device=dev)
    d = max(22, int(ref_labels.max()) + 1)
    onehot = torch.nn.functional.one_hot(ref_labels.reshape(k * p).long(), d).float()  # (K·P, D)
    ref = ref_feats.reshape(k * p, -1).float()
    idx = torch.arange(p, device=dev, dtype=torch.float32)
    ry, rx = idx / wd, torch.remainder(idx, wd)
    out = torch.empty(d, p, device=dev)
    for q0 in range(0, p, block):
        q1 = min(p, q0 + block)
        s = (ref @ target[q0:q1].float().T) * temperature  # (K·P, Q)
        e = torch.exp(s - s.amax(dim=0, keepdim=True))
        soft = e / e.sum(dim=0, keepdim=True)
        dist = (ry[:, None] - ry[None, q0:q1]) ** 2 + (rx[:, None] - rx[None, q0:q1]) ** 2  # (P, Q)
        w = torch.exp(-dist[None] * inv_s[:, None, None]).reshape(k * p, q1 - q0)
        out[:, q0:q1] = onehot.T @ (soft * w)
    return out
