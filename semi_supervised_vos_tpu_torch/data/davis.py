"""DAVIS-layout inference dataset (host side).

Directory scanning reproduces ``ImageFolder`` semantics (sorted class dirs,
recursively sorted files); encoded bytes are preloaded into RAM up front and
decoded on demand with PIL (reference ``src/utils/datasets.py:111-167``).
Frames are HWC uint8; normalisation runs on the device. The flip and
second-scale items of the multi-stream strategies follow
``datasets.py:148-162``.
"""

from __future__ import annotations

import dataclasses
from io import BytesIO
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageOps

from semi_supervised_vos_tpu_torch.utils.logging import logger

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def list_image_folder(root) -> Tuple[List[Tuple[str, int]], Dict[str, int]]:
    """ImageFolder-style listing: (path, class_idx) sorted by class then path."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for p in sorted((root / c).rglob("*")):
            if p.suffix.lower() in IMG_EXTENSIONS:
                samples.append((str(p), class_to_idx[c]))
    return samples, class_to_idx


def decode_rgb(blob: bytes) -> np.ndarray:
    """Decode an encoded image to (H, W, 3) uint8."""
    return np.asarray(Image.open(BytesIO(blob)).convert("RGB"), np.uint8)


def _preload(samples: Sequence[Tuple[str, int]], what: str) -> List[bytes]:
    logger.info(f"Loading {len(samples)} {what}.")
    blobs = [Path(p).read_bytes() for p, _ in samples]
    logger.info(f"{what} loaded: {len(blobs)}.")
    return blobs


@dataclasses.dataclass
class InferenceDataset:
    """One frame at a time: items are ((H, W, 3) uint8 frame, video name), or
    for ``hor-flip`` / ``vert-flip`` / ``2-scale`` / ``hor-2-scale`` a pair
    (frame, second-stream frame): mirrored, flipped, or resized by ``scale``
    with LANCZOS to ``ceil(size · scale)`` (hor-2-scale mirrors first)."""

    root: str
    inference_strategy: str = "single"
    scale: Optional[float] = None

    def __post_init__(self):
        self.imgs, self.class_to_idx = list_image_folder(self.root)
        self.idx_to_class = {v: k for k, v in self.class_to_idx.items()}
        self.img_bytes = _preload(self.imgs, "inference images")

    def __len__(self) -> int:
        return len(self.imgs)

    def __getitem__(self, index: int):
        _, video_index = self.imgs[index]
        name = self.idx_to_class[video_index]
        strat = self.inference_strategy
        if strat not in ("hor-flip", "vert-flip", "2-scale", "hor-2-scale"):
            return decode_rgb(self.img_bytes[index]), name
        img = Image.open(BytesIO(self.img_bytes[index])).convert("RGB")
        frame = np.asarray(img, np.uint8)
        if strat == "hor-flip":
            return (frame, np.asarray(ImageOps.mirror(img), np.uint8)), name
        if strat == "vert-flip":
            return (frame, np.asarray(ImageOps.flip(img), np.uint8)), name
        size2 = tuple(np.ceil(np.array(img.size) * self.scale).astype(np.int64))
        if strat == "hor-2-scale":
            img = ImageOps.mirror(img)
        # the reference's Image.ANTIALIAS (Pillow 8), an alias of LANCZOS
        return (frame, np.asarray(img.resize(size2, Image.LANCZOS), np.uint8)), name

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]
