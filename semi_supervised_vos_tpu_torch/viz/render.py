"""Video rendering: overlay, side-by-side, prediction-only — the port's copy
of the JAX package's ``viz/render.py`` (host only; no card).

Reference ``src/visualization/{overlay,side_by_side,prediction_only}.py``
drive the ffmpeg binary through ffmpeg-python. When an ffmpeg binary is on
PATH (or named in ``SVOS_FFMPEG``) the same pipelines run through it, with
the JAX renderer's argv: the same inputs, filters and codec selection as
the reference's ffmpeg-python graphs. Without the binary the pipelines fall
back to OpenCV's VideoWriter; ``SVOS_FFMPEG=0`` forces the fallback. With
neither ffmpeg nor OpenCV (``cv2``) a render raises.

* overlay: prediction PNGs alpha-keyed over the source frames — background
  (colour 0) transparent, foreground at alpha 128 (``overlay.py:13-26``),
  optional greyscale source (``overlay.py:50-51``);
* side-by-side: horizontal stack of prediction and source
  (``side_by_side.py:18-23``);
* prediction-only: the mask frames as a plain video
  (``prediction_only.py:16-19``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np
from PIL import Image

from semi_supervised_vos_tpu_torch.utils.logging import logger


def _frames(directory, pattern) -> List[Path]:
    # a killed overlay run can leave ``*.png.noback.png`` intermediates
    # behind; they would add duplicate frames to later renders
    return sorted(f for f in Path(directory).glob(pattern) if not f.name.endswith(".noback.png"))


def _clean_noback(directory) -> None:
    """Delete stale ``*.noback.png`` intermediates (from a killed overlay
    run) so the ffmpeg ``*.png`` globs see mask frames only."""
    for f in Path(directory).glob("*.noback.png"):
        f.unlink(missing_ok=True)


# ---- ffmpeg backend ----------------------------------------------------------


def ffmpeg_binary() -> Optional[str]:
    """The ffmpeg binary to drive, or None for the OpenCV fallback.

    ``SVOS_FFMPEG=<path>`` overrides discovery; ``SVOS_FFMPEG=0`` disables
    the backend even when a binary is on PATH."""
    env = os.environ.get("SVOS_FFMPEG")
    if env == "0":
        return None
    return env or shutil.which("ffmpeg")


def _remove_background(path) -> List[Path]:
    """Reference ``overlay.py:13-26``: write RGBA ``.noback.png`` copies with
    colour-0 pixels fully transparent and everything else at alpha 128."""
    made = []
    for file in _frames(path, "*.png"):
        data = np.array(Image.open(file).convert("RGBA"))
        mask = np.all(data[:, :, :3] == 0, axis=-1)
        data[mask] = [0, 0, 0, 0]
        data[np.logical_not(mask), 3] = 128
        out = Path(str(file) + ".noback.png")
        Image.fromarray(data).save(out)
        made.append(out)
    return made


def _run_ffmpeg(binary: str, args: List[str]) -> None:
    cmd = [binary, "-y", *args]
    logger.info("ffmpeg: " + " ".join(cmd))
    subprocess.run(cmd, check=True)


def _inputs(prediction_glob: str, source_dir, fps, png_codec: bool = True) -> List[str]:
    """``-framerate fps -pattern_type glob [-vcodec png] -i <predictions>``,
    then the source JPEGs the same way when ``source_dir`` is given."""
    args = ["-framerate", str(fps), "-pattern_type", "glob"]
    args += ["-vcodec", "png"] if png_codec else []
    args += ["-i", prediction_glob]
    if source_dir is not None:
        args += ["-framerate", str(fps), "-pattern_type", "glob", "-i", f"{source_dir}/*.jpg"]
    return args


def _ffmpeg_overlay(binary, prediction_dir, source_dir, output, fps, bw) -> None:
    """``overlay.py:45-56``: transparent predictions overlaid on the source
    (optionally greyscaled) — input 0 = predictions, input 1 = source, the
    overlay's main stream is the source."""
    _clean_noback(prediction_dir)
    made = _remove_background(prediction_dir)
    graph = "[1:v]format=gray[s];[s][0:v]overlay[out]" if bw else "[1:v][0:v]overlay[out]"
    try:
        _run_ffmpeg(binary, _inputs(f"{prediction_dir}/*.noback.png", source_dir, fps)
                    + ["-filter_complex", graph, "-map", "[out]", str(output)])
    finally:
        for f in made:  # reference cleanup(), overlay.py:29-32
            f.unlink(missing_ok=True)


def _ffmpeg_side_by_side(binary, prediction_dir, source_dir, output, fps) -> None:
    """``side_by_side.py:18-23``: hstack(prediction, source)."""
    _clean_noback(prediction_dir)
    _run_ffmpeg(binary, _inputs(f"{prediction_dir}/*.png", source_dir, fps)
                + ["-filter_complex", "[0:v][1:v]hstack[out]", "-map", "[out]", str(output)])


def _ffmpeg_prediction_only(binary, prediction_dir, output, fps) -> None:
    """``prediction_only.py:16-19``: the mask frames as a plain video."""
    _clean_noback(prediction_dir)
    _run_ffmpeg(binary, _inputs(f"{prediction_dir}/*.png", None, fps, png_codec=False) + [str(output)])


# ---- OpenCV fallback ---------------------------------------------------------


def _writer(output, fps, size_wh):
    try:
        import cv2
    except ImportError as err:
        raise RuntimeError(
            "rendering needs the ffmpeg binary (on PATH or named in SVOS_FFMPEG) or OpenCV (the cv2 module); "
            "neither is available"
        ) from err
    return cv2.VideoWriter(str(output), cv2.VideoWriter_fourcc(*"mp4v"), fps, size_wh)


def _to_bgr(img: Image.Image) -> np.ndarray:
    return np.asarray(img.convert("RGB"))[:, :, ::-1].copy()


def _pred_bgr(path, hw) -> np.ndarray:
    """A prediction PNG as BGR at the source's (h, w), nearest-resized."""
    pred = _to_bgr(Image.open(path))
    if pred.shape[:2] != hw:
        pred = np.asarray(Image.fromarray(pred[:, :, ::-1]).resize(hw[::-1], Image.NEAREST))[:, :, ::-1]
    return pred


def render_overlay(prediction_dir, source_dir, output, fps: int = 15, bw: bool = False) -> None:
    """Alpha-composite masks over source frames (reference ``overlay.py``)."""
    binary = ffmpeg_binary()
    if binary:
        _ffmpeg_overlay(binary, prediction_dir, source_dir, output, fps, bw)
        return
    preds, srcs = _frames(prediction_dir, "*.png"), _frames(source_dir, "*.jpg")
    if not (preds and srcs):
        raise FileNotFoundError(f"no frames found in {prediction_dir} or {source_dir}")
    h, w = _to_bgr(Image.open(srcs[0])).shape[:2]
    out = _writer(output, fps, (w, h))
    for pred_path, src_path in zip(preds, srcs):
        src = _to_bgr(Image.open(src_path))
        if bw:
            grey = (0.114 * src[:, :, 0] + 0.587 * src[:, :, 1] + 0.299 * src[:, :, 2]).astype(np.uint8)
            src = np.stack([grey] * 3, axis=-1)
        pred = _pred_bgr(pred_path, (h, w))
        # background (colour 0 == black) transparent, foreground alpha 128
        alpha = np.any(pred != 0, axis=-1, keepdims=True).astype(np.float32) * (128.0 / 255.0)
        out.write((src * (1 - alpha) + pred * alpha).astype(np.uint8))
    out.release()
    logger.info(f"overlay video written to {output}")


def render_side_by_side(prediction_dir, source_dir, output, fps: int = 15) -> None:
    """Horizontal stack (reference ``side_by_side.py``)."""
    binary = ffmpeg_binary()
    if binary:
        _ffmpeg_side_by_side(binary, prediction_dir, source_dir, output, fps)
        return
    preds, srcs = _frames(prediction_dir, "*.png"), _frames(source_dir, "*.jpg")
    if not (preds and srcs):
        raise FileNotFoundError(f"no frames found in {prediction_dir} or {source_dir}")
    h, w = _to_bgr(Image.open(srcs[0])).shape[:2]
    out = _writer(output, fps, (2 * w, h))
    for pred_path, src_path in zip(preds, srcs):
        out.write(np.concatenate([_pred_bgr(pred_path, (h, w)), _to_bgr(Image.open(src_path))], axis=1))
    out.release()
    logger.info(f"side-by-side video written to {output}")


def render_prediction_only(prediction_dir, output, fps: int = 15) -> None:
    """Masks as a plain video (reference ``prediction_only.py``)."""
    binary = ffmpeg_binary()
    if binary:
        _ffmpeg_prediction_only(binary, prediction_dir, output, fps)
        return
    preds = _frames(prediction_dir, "*.png")
    if not preds:
        raise FileNotFoundError(f"no frames found in {prediction_dir}")
    h, w = _to_bgr(Image.open(preds[0])).shape[:2]
    out = _writer(output, fps, (w, h))
    for pred_path in preds:
        out.write(_to_bgr(Image.open(pred_path)))
    out.release()
    logger.info(f"prediction video written to {output}")
