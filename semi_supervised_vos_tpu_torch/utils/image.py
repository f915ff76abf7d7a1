"""Palette-PNG prediction IO.

Per-video folders under the save dir; frame ``00000.png`` is the copied
first annotation, frames ``00001.png`` onwards are predictions rendered as
P-mode PNGs carrying the source palette (reference
``src/utils/utils.py:34-42,97-100``, ``src/model/predict.py:120-126``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from semi_supervised_vos_tpu_torch.utils.logging import logger
from semi_supervised_vos_tpu_torch.utils.profiling import span


def load_annotation(path) -> Tuple[np.ndarray, int, Optional[list]]:
    """Read a palette annotation PNG: (label map (H, W) int32,
    d = max_label + 1, palette)."""
    img = Image.open(path)
    label = np.asarray(img).astype(np.int32)
    palette = img.getpalette()
    d = int(label.max()) + 1
    return label, d, palette


def copy_first_annotation(annotation_path, save_dir, video_name) -> None:
    """Copy the frame-0 annotation into the output tree."""
    out = Path(save_dir) / video_name
    out.mkdir(parents=True, exist_ok=True)
    Image.open(annotation_path).save(out / "00000.png")


def save_prediction(
    prediction: np.ndarray, palette, save_path, save_name: str, video_name: str
) -> None:
    """Write one prediction frame as a P-mode PNG (span ``png.write``)."""
    with span("png.write"):
        img = Image.fromarray(prediction.astype(np.int32))
        img = img.convert("L")
        if palette is not None:
            img.putpalette(palette)
        img = img.convert("P")
        video_path = Path(save_path) / video_name
        video_path.mkdir(parents=True, exist_ok=True)
        img.save((video_path / (save_name + ".png")).absolute())


def save_predictions(
    predictions: Sequence[np.ndarray], palette, save, video_name: str
) -> None:
    """Write a video's predictions, numbered from 00001."""
    for idx, prediction in enumerate(predictions, start=1):
        save_prediction(np.asarray(prediction), palette, save, str(idx).zfill(5), video_name)


def first_annotation_path(annotation_dir, video_name):
    """A video's first-frame annotation: ``00000.png`` when present, else the
    lexicographically first PNG (logged); raises when there is none."""
    video_dir = Path(annotation_dir) / video_name
    preferred = video_dir / "00000.png"
    if preferred.exists():
        return preferred
    candidates = sorted(video_dir.glob("*.png"))
    if candidates:
        logger.warning(
            f"{video_name}: no 00000.png annotation; using {candidates[0].name}"
        )
        return candidates[0]
    raise FileNotFoundError(
        f"no first-frame annotation for video '{video_name}' under {video_dir} "
        f"(expected 00000.png or any .png)"
    )
