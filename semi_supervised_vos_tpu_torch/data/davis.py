"""DAVIS-layout datasets (host side): training clips and inference frames.

Directory scanning reproduces ``ImageFolder`` semantics (sorted class dirs,
recursively sorted files); encoded bytes are preloaded into RAM up front and
decoded on demand with PIL, or with the native JPEG decoder under
``SVOS_NATIVE_DECODE=1`` (reference ``src/utils/datasets.py:19-167``).
Frames are HWC uint8; normalisation, centroid quantisation and one-hot
encoding run on the device. The flip and second-scale items of the
multi-stream strategies follow ``datasets.py:148-162``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from io import BytesIO
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageOps

from semi_supervised_vos_tpu_torch.data import native_decode
from semi_supervised_vos_tpu_torch.data.transforms import FixedColorJitter, get_crop_params, hflip, pil_crop, vflip
from semi_supervised_vos_tpu_torch.utils.logging import logger
from semi_supervised_vos_tpu_torch.utils.profiling import count, span

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")

# PIL >= 10 removed the ANTIALIAS alias (the reference pins Pillow 8,
# ``datasets.py:146``); LANCZOS is the same filter.
ANTIALIAS = getattr(Image, "ANTIALIAS", Image.LANCZOS)


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
    """Decode an encoded image to (H, W, 3) uint8: a JPEG through the native
    threaded decoder while it is on (``SVOS_NATIVE_DECODE=1``; the same
    bytes as PIL's, checked at first use), anything else through PIL."""
    if blob[:2] == b"\xff\xd8" and native_decode.available():
        return native_decode.decode_jpeg(blob)
    return np.asarray(Image.open(BytesIO(blob)).convert("RGB"), np.uint8)


def decode_ann_rgb(blob: bytes) -> np.ndarray:
    """Annotation decode to (H, W, 3) uint8 RGB. A palette PNG maps through
    its palette (equal to ``convert("RGB")`` for P-mode images, without
    PIL's per-pixel convert)."""
    img = Image.open(BytesIO(blob))
    if img.mode == "P":
        idx = np.asarray(img, np.uint8)
        pal = np.zeros((256, 3), np.uint8)
        raw = img.getpalette()
        pal[: len(raw) // 3] = np.asarray(raw, np.uint8).reshape(-1, 3)
        return pal[idx]
    return np.asarray(img.convert("RGB"), np.uint8)


def _preload(samples: Sequence[Tuple[str, int]], what: str) -> List[bytes]:
    logger.info(f"Loading {len(samples)} {what}.")
    blobs = [Path(p).read_bytes() for p, _ in samples]
    logger.info(f"{what} loaded: {len(blobs)}.")
    return blobs


@dataclasses.dataclass
class TrainDataset:
    """Training clips (reference ``datasets.py:19-108``).

    An item is ``frame_num`` consecutive frames of one video with one shared
    random crop, horizontal and vertical flip and (optionally) colour jitter:
    ((T, crop, crop, 3) uint8 images, (T, crop, crop, 3) uint8 RGB
    annotations, video index). The draws come from ``self.rng`` in the JAX
    package's order (jitter factors, the two flips, then the crop), so one
    seed gives the same items in both packages.

    ``decode_cache`` also keeps the decoded full frames in RAM: the first
    epoch decodes each frame once and later epochs only crop, flip and
    jitter the cached arrays (about 2.5 MB a 480p frame pair). Default: the
    ``SVOS_DECODE_CACHE`` environment variable ("1" turns it on). A race
    between prefetch threads decodes a frame twice and stores equal arrays.
    """

    img_root: str
    annotation_root: str
    cropping: int = 256
    frame_num: int = 10
    color_jitter: bool = False
    decode_cache: Optional[bool] = None

    def __post_init__(self):
        self.imgs, self.class_to_idx = list_image_folder(self.img_root)
        self.annotations, _ = list_image_folder(self.annotation_root)
        self.img_bytes = _preload(self.imgs, "train images")
        self.annotation_bytes = _preload(self.annotations, "train annotations")
        self.rng = np.random.default_rng(42)
        if self.decode_cache is None:
            self.decode_cache = os.environ.get("SVOS_DECODE_CACHE", "0") == "1"
        self._img_cache: Optional[List[Optional[np.ndarray]]] = [None] * len(self.imgs) if self.decode_cache else None
        self._ann_cache: Optional[List[Optional[np.ndarray]]] = (
            [None] * len(self.annotations) if self.decode_cache else None
        )

    def _image(self, idx: int) -> np.ndarray:
        if self._img_cache is None:
            return decode_rgb(self.img_bytes[idx])
        if self._img_cache[idx] is None:
            self._img_cache[idx] = decode_rgb(self.img_bytes[idx])
        return self._img_cache[idx]

    def _annotation(self, idx: int) -> np.ndarray:
        if self._ann_cache is None:
            return decode_ann_rgb(self.annotation_bytes[idx])
        if self._ann_cache[idx] is None:
            self._ann_cache[idx] = decode_ann_rgb(self.annotation_bytes[idx])
        return self._ann_cache[idx]

    def __len__(self) -> int:
        return len(self.imgs)

    def seed(self, seed: int) -> None:
        """Reseed the augmentation (the reference reseeds every epoch,
        ``train.py:132``)."""
        self.rng = np.random.default_rng(seed)

    def _is_same_video(self, index: int) -> bool:
        return self.imgs[index][1] == self.imgs[index + self.frame_num - 1][1]

    def plan(self, index: int):
        """Draw item ``index``'s augmentation now (jitter factors, the two
        flips, then the crop, the JAX package's order) and return a call
        that decodes it. ``iterate_batches`` draws in index order on one
        thread and decodes on several, so items do not depend on the
        thread count."""
        if index + self.frame_num > len(self.imgs):
            index = len(self.imgs) - self.frame_num
        while not self._is_same_video(index):
            index -= 1
        jitter = FixedColorJitter(0.4, 0.4, 0.4, 0.4, rng=self.rng) if self.color_jitter else None
        h_flip = bool(self.rng.random() < 0.5)
        v_flip = bool(self.rng.random() < 0.5)
        with Image.open(BytesIO(self.img_bytes[index])) as im0:
            size = im0.size  # the header only; flips keep the size
        crop = get_crop_params(size, self.cropping, self.rng)
        if jitter is not None:
            return functools.partial(self._load_pil, index, jitter, h_flip, v_flip, crop)
        return functools.partial(self._load, index, h_flip, v_flip, crop, size[1])

    def __getitem__(self, index: int):
        return self.plan(index)()

    def _load(self, index: int, h_flip: bool, v_flip: bool, crop, height: int):
        """Flip as views, then copy the crop: crop(flip(x)), as the
        reference does it. With the native decoder on and no decode cache,
        a JPEG frame decodes only the row band the crop covers (raw rows
        [height − ci − th, height − ci) under a vertical flip), the same
        bytes as those rows of a whole decode."""
        ci, cj, th, tw = crop
        rows = self._img_cache is None and th < height and native_decode.available()
        y0 = height - (ci + th) if v_flip else ci
        imgs, anns = [], []
        for i in range(self.frame_num):
            blob, ann = self.img_bytes[index + i], self._annotation(index + i)
            if rows and blob[:2] == b"\xff\xd8":
                img = native_decode.decode_jpeg_rows(blob, y0, th)
                img = vflip(img) if v_flip else img
                img = hflip(img) if h_flip else img
                imgs.append(np.ascontiguousarray(img[:, cj : cj + tw]))
            else:
                img = self._image(index + i)
                img = hflip(img) if h_flip else img
                img = vflip(img) if v_flip else img
                imgs.append(np.ascontiguousarray(img[ci : ci + th, cj : cj + tw]))
            ann = hflip(ann) if h_flip else ann
            ann = vflip(ann) if v_flip else ann
            anns.append(np.ascontiguousarray(ann[ci : ci + th, cj : cj + tw]))
        return np.stack(imgs), np.stack(anns), self.imgs[index + self.frame_num - 1][1]

    def _load_pil(self, index: int, jitter: FixedColorJitter, h_flip: bool, v_flip: bool, crop):
        """The colour-jitter path, on PIL images as the reference's
        ``datasets.py:66-71``."""
        ci, cj, th, tw = crop
        imgs, anns = [], []
        for i in range(self.frame_num):
            img = Image.fromarray(self._image(index + i))
            ann = Image.fromarray(self._annotation(index + i))
            if h_flip:
                img, ann = img.transpose(Image.FLIP_LEFT_RIGHT), ann.transpose(Image.FLIP_LEFT_RIGHT)
            if v_flip:
                img, ann = img.transpose(Image.FLIP_TOP_BOTTOM), ann.transpose(Image.FLIP_TOP_BOTTOM)
            imgs.append(np.asarray(jitter(pil_crop(img, ci, cj, th, tw)), np.uint8))
            anns.append(np.asarray(pil_crop(ann, ci, cj, th, tw), np.uint8))
        return np.stack(imgs), np.stack(anns), self.imgs[index + self.frame_num - 1][1]


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
        """Item ``index``, decoded in span ``data.decode`` (counter
        ``data.frames``) while the recorder records."""
        with span("data.decode"):
            item = self._item(index)
        count("data.frames")
        return item

    def _item(self, index: int):
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
        return (frame, np.asarray(img.resize(size2, ANTIALIAS), np.uint8)), name

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]


@dataclasses.dataclass
class TripletLossTrainDataset:
    """Whole-video sequence dataset grouped by video (reference
    ``datasets.py:170-219``; dead code there, kept for surface parity).

    Items are lists of ((H, W, 3) uint8 image, (H, W, 3) uint8 RGB
    annotation) pairs, one per frame of the video."""

    img_root: str
    annotation_root: str

    def __post_init__(self):
        imgs, _ = list_image_folder(self.img_root)
        anns, _ = list_image_folder(self.annotation_root)
        assert len(imgs) == len(anns)
        self.data: Dict[int, list] = {}
        logger.info(f"Loading {len(imgs)} train image, annotation pairs.")
        for (ip, ic), (ap, ac) in zip(imgs, anns):
            assert ic == ac
            self.data.setdefault(ic, []).append((Path(ip).read_bytes(), Path(ap).read_bytes()))
        logger.info(f"Pairs loaded: {len(self.data)}.")

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        return [(np.asarray(Image.open(BytesIO(img)).convert("RGB"), np.uint8),
                 np.asarray(Image.open(BytesIO(ann)).convert("RGB"), np.uint8)) for img, ann in self.data[index]]
