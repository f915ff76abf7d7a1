"""DAVIS segmentation metrics: region similarity J and boundary F.

Reference ``src/utils/metrics.py`` (itself the standard DAVIS benchmark
code). Host-side NumPy/SciPy — this is an offline metric path, not a device
concern. skimage is not a dependency, so the disk structuring
element and greyscale dilation are implemented here with SciPy (identical
results on binary boundary maps).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def evaluate_segmentation(
    annotation: np.ndarray,
    segmentation: np.ndarray,
    void_pixels: Optional[np.ndarray] = None,
    threshold: float = 0.008,
) -> Tuple[float, float]:
    """(J, F) for one binary mask pair (reference ``metrics.py:11-12``)."""
    return (
        eval_j(annotation, segmentation, void_pixels),
        eval_f(annotation, segmentation, void_pixels, threshold),
    )


def eval_j(annotation, segmentation, void_pixels=None):
    """Jaccard index with void-pixel support (reference ``metrics.py:15-45``)."""
    assert annotation.shape == segmentation.shape
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    if void_pixels is not None:
        assert annotation.shape == void_pixels.shape
        void_pixels = void_pixels.astype(bool)
    else:
        void_pixels = np.zeros_like(segmentation)

    inters = np.sum((segmentation & annotation) & np.logical_not(void_pixels), axis=(-2, -1))
    union = np.sum((segmentation | annotation) & np.logical_not(void_pixels), axis=(-2, -1))

    with np.errstate(divide="ignore", invalid="ignore"):
        j = inters / union
    if np.ndim(j) == 0:
        j = 1 if np.isclose(union, 0) else float(j)
    else:
        j[np.isclose(union, 0)] = 1
    return j


def eval_f(annotation, segmentation, void_pixels=None, bound_th=0.008):
    """Boundary F-measure, per frame for 3-D stacks (reference
    ``metrics.py:48-63``)."""
    assert annotation.shape == segmentation.shape
    if void_pixels is not None:
        assert annotation.shape == void_pixels.shape
    if annotation.ndim == 3:
        n_frames = annotation.shape[0]
        f_res = np.zeros(n_frames)
        for t in range(n_frames):
            void_t = None if void_pixels is None else void_pixels[t]
            f_res[t] = f_measure(segmentation[t], annotation[t], void_t, bound_th=bound_th)
        return f_res
    if annotation.ndim == 2:
        return f_measure(segmentation, annotation, void_pixels, bound_th=bound_th)
    raise ValueError(f"unsupported ndim {annotation.ndim}")


def disk(radius: int) -> np.ndarray:
    """Disk structuring element (skimage.morphology.disk equivalent):
    ones where x^2 + y^2 <= r^2 on a (2r+1)^2 grid."""
    radius = int(radius)
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def _binary_dilation_disk(mask: np.ndarray, radius: int) -> np.ndarray:
    """Dilation by a disk; equals skimage greyscale dilation on binary input
    (reference ``metrics.py:92-94``)."""
    if radius < 1:
        return mask.astype(np.uint8)
    return ndimage.binary_dilation(mask.astype(bool), structure=disk(radius).astype(bool)).astype(np.uint8)


def f_measure(foreground_mask, gt_mask, void_pixels=None, bound_th=0.008):
    """Boundary precision/recall F (reference ``metrics.py:66-124``)."""
    assert np.atleast_3d(foreground_mask).shape[2] == 1
    if void_pixels is not None:
        void_pixels = void_pixels.astype(bool)
    else:
        void_pixels = np.zeros_like(foreground_mask).astype(bool)

    bound_pix = (
        bound_th
        if bound_th >= 1
        else np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))
    )

    fg_boundary = _seg2bmap(foreground_mask * np.logical_not(void_pixels))
    gt_boundary = _seg2bmap(gt_mask * np.logical_not(void_pixels))

    fg_dil = _binary_dilation_disk(fg_boundary, int(bound_pix))
    gt_dil = _binary_dilation_disk(gt_boundary, int(bound_pix))

    gt_match = gt_boundary * fg_dil
    fg_match = fg_boundary * gt_dil

    n_fg = np.sum(fg_boundary)
    n_gt = np.sum(gt_boundary)

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1, 0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0, 1
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1, 1
    else:
        precision = np.sum(fg_match) / float(n_fg)
        recall = np.sum(gt_match) / float(n_gt)

    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _seg2bmap(seg, width=None, height=None):
    """Binary boundary map with the half-pixel-toward-origin convention of
    the DAVIS toolkit / David Martin BSDS code (the algorithm the reference
    vendors at ``metrics.py:127-183``).

    A pixel is boundary when it differs from its east, south, or south-east
    neighbour; the last row/column fall back to the single in-bounds
    comparison and the bottom-right corner is never boundary.

    Deviations from the vendored original, on purpose: the dimension guard is
    written with boolean operators (the original's ``|`` binds before ``>``,
    so its assert never checked anything), and the optional rescale to a
    different (width, height) — dead code upstream, since callers always
    resize first — is a straightforward nearest-index placement instead of
    the original's uncomputable ``width / h`` expression.
    """
    seg = seg.astype(bool)
    assert np.atleast_3d(seg).shape[2] == 1

    h, w = seg.shape[:2]
    width = w if width is None else width
    height = h if height is None else height
    aspect_drift = abs(width / height - w / h)
    if width > w or height > h or aspect_drift > 0.01:
        raise ValueError(f"cannot map a {w}x{h} mask onto a {width}x{height} boundary grid")

    east = np.zeros_like(seg)
    south = np.zeros_like(seg)
    south_east = np.zeros_like(seg)
    east[:, :-1] = seg[:, 1:]
    south[:-1, :] = seg[1:, :]
    south_east[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ east) | (seg ^ south) | (seg ^ south_east)
    b[-1, :] = seg[-1, :] ^ east[-1, :]
    b[:, -1] = seg[:, -1] ^ south[:, -1]
    b[-1, -1] = False

    if (w, h) == (width, height):
        return b
    ys, xs = np.nonzero(b)
    bmap = np.zeros((height, width), bool)
    bmap[np.floor(ys * height / h).astype(int), np.floor(xs * width / w).astype(int)] = True
    return bmap
