"""Host-side morphology for the skeleton and distance-transform miners: the
port's copy of the JAX package's ``utils/morphology.py``.

``skeletonize`` is Zhang-Suen thinning (a one-pixel-wide medial-axis
skeleton, the algorithm family of the reference's
``skimage.morphology.skeletonize``); the distance transforms come from SciPy
(reference ``src/model/triplet_miners.py:174-180``).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def distance_transform(mask: np.ndarray, metric: str = "euclidean", return_indices: bool = False):
    """Distance to the nearest zero pixel and, optionally, its indices:
    ``euclidean`` → ``distance_transform_edt``, any other metric →
    ``distance_transform_cdt`` with that metric."""
    if metric == "euclidean":
        return ndimage.distance_transform_edt(mask, return_indices=return_indices)
    return ndimage.distance_transform_cdt(mask, metric=metric, return_indices=return_indices)


_ZS_NEIGHBOURS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]  # P2..P9 clockwise from north


def _zhang_suen_tables():
    """For each 8-neighbourhood code (bit k set when neighbour P(k+2) is
    set), whether the first and the second sub-iteration delete the pixel:
    2 <= B <= 6 set neighbours, A == 1 0->1 transitions around the ring,
    and each sub-iteration's two products of neighbours zero."""
    p = [(np.arange(256) >> k) & 1 for k in range(8)]
    b = sum(p)
    a = sum((p[k] == 0) & (p[(k + 1) % 8] == 1) for k in range(8))
    base = (b >= 2) & (b <= 6) & (a == 1)
    first = base & (p[0] * p[2] * p[4] == 0) & (p[2] * p[4] * p[6] == 0)
    second = base & (p[0] * p[2] * p[6] == 0) & (p[0] * p[4] * p[6] == 0)
    return first, second


_ZS_TABLES = _zhang_suen_tables()


def skeletonize_many(masks: np.ndarray) -> np.ndarray:
    """Zhang-Suen thinning of each (H, W) mask of an (N, H, W) stack to a
    one-pixel-wide skeleton (uint8 0/1): the JAX package's ``skeletonize``,
    pixel for pixel, with each sub-iteration one table lookup of every
    pixel's neighbourhood code over the whole stack. A mask that has stopped
    changing stays as it is while the others thin."""
    masks = np.asarray(masks)
    n, h, w = masks.shape
    img = np.zeros((n, h + 2, w + 2), np.uint8)  # zero border: the neighbours outside the mask
    img[:, 1:-1, 1:-1] = masks > 0
    inner = img[:, 1:-1, 1:-1]
    changed = True
    while changed:
        changed = False
        for table in _ZS_TABLES:
            code = np.zeros((n, h, w), np.uint8)
            for k, (dy, dx) in enumerate(_ZS_NEIGHBOURS):
                code |= img[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] << k
            delete = (inner == 1) & table[code]
            if delete.any():
                inner[delete] = 0
                changed = True
    return inner.copy()


def skeletonize(mask: np.ndarray) -> np.ndarray:
    """Zhang-Suen thinning of one mask to a one-pixel-wide skeleton (uint8
    0/1)."""
    return skeletonize_many(np.asarray(mask)[None])[0]
