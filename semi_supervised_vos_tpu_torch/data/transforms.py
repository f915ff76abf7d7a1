"""Host-side image transforms for training clips (reference
``src/utils/transforms.py``), the port's copy of the JAX package's.

Random parameters come from an explicit ``numpy.random.Generator``, drawn in
the same order as the JAX package draws them, so that one seed gives both
packages the same crops, flips and colour jitter.
"""

from __future__ import annotations

import numbers
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance


def get_crop_params(img_size, output_size, rng: np.random.Generator) -> Tuple[int, int, int, int]:
    """Random crop box (i, j, th, tw) for a (w, h) image (reference
    ``transforms.py:13-33``); a crop larger than the image is clamped to it."""
    w, h = img_size
    if isinstance(output_size, numbers.Number):
        th, tw = int(output_size), int(output_size)
    else:
        th, tw = output_size
    th, tw = min(th, h), min(tw, w)
    if w == tw and h == th:
        return 0, 0, h, w
    i = int(rng.integers(0, h - th)) if h > th else 0
    j = int(rng.integers(0, w - tw)) if w > tw else 0
    return i, j, th, tw


def pil_crop(img: Image.Image, i: int, j: int, h: int, w: int) -> Image.Image:
    """Crop a PIL image (reference ``transforms.py:36-47``)."""
    return img.crop((j, i, j + w, i + h))


class FixedColorJitter:
    """Colour jitter whose factors are drawn once, at construction, so every
    frame of a clip gets the same jitter (reference ``transforms.py:50-61``):
    factors uniform in [max(0, 1-x), 1+x] (hue in [-h, h]), applied in a
    random order of brightness, contrast, saturation and hue."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0, *, rng=None):
        rng = rng or np.random.default_rng()
        self.order = rng.permutation(4)
        self.brightness = float(rng.uniform(max(0, 1 - brightness), 1 + brightness))
        self.contrast = float(rng.uniform(max(0, 1 - contrast), 1 + contrast))
        self.saturation = float(rng.uniform(max(0, 1 - saturation), 1 + saturation))
        self.hue = float(rng.uniform(-hue, hue)) if hue > 0 else 0.0

    def _adjust_hue(self, img: Image.Image) -> Image.Image:
        if self.hue == 0.0:
            return img
        h, s, v = img.convert("HSV").split()
        np_h = (np.asarray(h, dtype=np.uint8).astype(np.int16) + int(self.hue * 255)) % 256
        h = Image.fromarray(np_h.astype(np.uint8), "L")
        return Image.merge("HSV", (h, s, v)).convert("RGB")

    def __call__(self, img: Image.Image) -> Image.Image:
        for op in self.order:
            if op == 0:
                img = ImageEnhance.Brightness(img).enhance(self.brightness)
            elif op == 1:
                img = ImageEnhance.Contrast(img).enhance(self.contrast)
            elif op == 2:
                img = ImageEnhance.Color(img).enhance(self.saturation)
            else:
                img = self._adjust_hue(img)
        return img


def hflip(x: np.ndarray) -> np.ndarray:
    """Horizontal flip of a channels-last (..., H, W, C) array (reference
    ``transforms.py:102-116``)."""
    return x[..., ::-1, :]


def vflip(x: np.ndarray) -> np.ndarray:
    """Vertical flip of a channels-last (..., H, W, C) array (reference
    ``transforms.py:119-130``)."""
    return x[..., ::-1, :, :]
