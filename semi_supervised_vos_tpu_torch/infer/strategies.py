"""Inference strategies. Ported so far: ``single`` (reference
``src/utils/inference_utils.py:23-87``), one propagation stream per video.

Frames buffer into chunks of ``SVOS_CHUNK`` (default 8); each chunk is one
batched encode plus a sequential propagation on the device
(``PropagationEngine.step_chunk_small``). Masks come back at feature
resolution once per chunk and are nearest-upsampled on the host by the
drain worker (argmax commutes with nearest upsampling, so this equals the
reference's upsample-then-argmax).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from semi_supervised_vos_tpu_torch.data.loader import prefetch_dataset
from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host
from semi_supervised_vos_tpu_torch.utils.image import (
    copy_first_annotation,
    first_annotation_path,
    load_annotation,
    save_predictions,
)


def chunk_len() -> int:
    """Frames per device chunk (``SVOS_CHUNK``, clamped to >= 1)."""
    return max(1, int(os.environ.get("SVOS_CHUNK", "8")))


def run_streams(
    dataset,
    annotation_dir,
    save_dir,
    make_engine: Callable[[tuple, int], PropagationEngine],
    progress: Optional[Callable[[], None]] = None,
) -> None:
    """Per-frame loop over an ordered (video-grouped) dataset with one
    propagation stream. ``make_engine(frame_hw, num_classes)`` builds an
    engine; it is rebuilt when the resolution changes or a video has more
    objects than the current class budget."""
    chunk_n = chunk_len()
    engine: Optional[PropagationEngine] = None
    state = None
    drain = MaskDrain()
    pending: List[np.ndarray] = []
    palette = None
    last_video = None
    frame_idx = 0
    out_hw = None

    def run_pending():
        nonlocal frame_idx, state
        if not pending:
            return
        masks, state = engine.step_chunk_small(np.stack(pending), state, frame_idx)

        def convert(m=masks, hw=out_hw):
            a = m.cpu().numpy()
            if a.shape[1:3] != tuple(hw):
                a = nearest_resize_host(a, hw, hw_axes=(1, 2))
            return list(a)

        drain.submit(convert)
        frame_idx += len(pending)
        pending.clear()

    def flush():
        if last_video is None:
            return
        run_pending()
        masks = [m for group in drain.drain() for m in group]
        if masks:
            save_predictions(masks, palette, save_dir, last_video)

    try:
        for frame, video in prefetch_dataset(dataset):
            if video != last_video and last_video is not None:
                flush()
                frame_idx = 0
            if frame_idx == 0:
                out_hw = frame.shape[:2]
                annotation = first_annotation_path(annotation_dir, video)
                label, d, palette = load_annotation(annotation)
                budget = engine.cfg.num_classes if engine is not None else 0
                if engine is None or (engine.h, engine.w) != tuple(out_hw) or d > budget:
                    engine = make_engine(tuple(out_hw), max(d, budget))
                copy_first_annotation(annotation, save_dir, video)
                state = engine.start_video(frame, label)
                frame_idx = 1
            else:
                pending.append(frame)
                if len(pending) == chunk_n:
                    run_pending()
            last_video = video
            if progress:
                progress()
        flush()
    finally:
        drain.close()


def inference_single(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, device, progress=None) -> None:
    """The ``single`` strategy: one stream, argmax of the propagated labels."""
    import dataclasses

    def make(hw, d):
        c = cfg if d <= cfg.num_classes else dataclasses.replace(cfg, num_classes=d)
        return PropagationEngine(model, hw, c, device)

    run_streams(dataset, annotation_dir, save_dir, make, progress)
