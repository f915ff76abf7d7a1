"""The seven inference strategies (reference ``src/utils/inference_utils.py``):
``single`` (:23), ``hor-flip`` (:90), ``vert-flip`` (:196), ``2-scale`` /
``hor-2-scale`` (:302), ``multimodel`` (:411) and ``3-scale`` (:514). Each
runs one to three propagation streams and fuses their masks:

* label propagation (default): per stream a nearest upsample of the argmax,
  then the elementwise **max of class indices** (``inference_utils.py:184``);
* ``--probability``: per-stream upsampled score maps combined with the
  ``maximum`` / ``minimum`` / ``mean`` reduction (``:18-20``), rounded to
  float16 as the reference's ``.cpu().half()`` does, then the argmax.

Frames buffer into chunks of ``SVOS_CHUNK`` (default 8). With one stream a
chunk is one batched encode plus a sequential propagation on the device
(``PropagationEngine.step_chunk_small``); masks come back at feature
resolution once per chunk and are nearest-upsampled on the host by the
drain worker (argmax commutes with nearest upsampling, so this equals the
reference's upsample-then-argmax). With several streams each stream turns
the chunk into raw (N, D, P) scores (``step_chunk_scores``; the final
partial chunk is padded by repeating its last frame: the video is over, so
what that does to the bank is never read), the fusion runs on the device one
frame at a time, and one (N, H, W) uint8 tensor per chunk goes to the host.

Deviations from the reference, kept from the JAX package (``PARITY.md``):
  * ``vert-flip`` un-flips its second stream with ``fliplr`` in the
    reference (``inference_utils.py:279``) even though the stream is
    vertically flipped; here it un-flips vertically.
  * probability mode + flip strategies apply ``torch.fliplr`` to a
    (1, d, H, W) tensor in the reference, flipping the *class* axis; here
    the spatial axis is flipped.
  * ``hor-2-scale`` mirrors the second input stream but not its first-frame
    labels (``predict.py:136-142``); here the labels are mirrored to match.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.data.loader import prefetch_dataset
from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize, nearest_resize_host
from semi_supervised_vos_tpu_torch.utils.image import (
    copy_first_annotation,
    first_annotation_path,
    load_annotation,
    save_predictions,
)
from semi_supervised_vos_tpu_torch.utils.logging import logger
from semi_supervised_vos_tpu_torch.utils.profiling import span

REDUCTIONS = {
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "mean": lambda x, y: (x + y) / 2.0,
}


def chunk_len() -> int:
    """Frames per device chunk (``SVOS_CHUNK``, clamped to >= 1)."""
    return max(1, int(os.environ.get("SVOS_CHUNK", "8")))


@dataclasses.dataclass
class Stream:
    """One propagation stream of a strategy."""

    engine: PropagationEngine
    input_idx: Optional[int]  # index into the dataset item tuple (None = whole item)
    label_flip: Optional[str] = None  # flip of the first-frame labels: 'h' | 'v'
    pred_flip: Optional[str] = None  # flip of the full-res prediction: 'h' | 'v'
    state: object = None


def _flip_label(label: np.ndarray, how: Optional[str]) -> np.ndarray:
    if how == "h":
        return np.ascontiguousarray(label[:, ::-1])
    if how == "v":
        return np.ascontiguousarray(label[::-1, :])
    return label


def _with_budget(cfg: EngineConfig, num_classes: int) -> EngineConfig:
    """Grow the padded class budget when a video has more objects than the
    default 22-colour table (the reference sizes d per video,
    ``predict.py:113``)."""
    if num_classes <= cfg.num_classes:
        return cfg
    return dataclasses.replace(cfg, num_classes=num_classes)


def _make_engine(model, hw, cfg: EngineConfig, device, mesh=None) -> PropagationEngine:
    """The one-card engine, or with a mesh the bank-sharded engine
    (``--bank-shards``; ``parallel/engine_sharded.py``). Every strategy
    builds its engines here, so bank sharding composes with all seven: each
    stream's bank shards its pixel rows and the fusion is unchanged."""
    if mesh is None:
        return PropagationEngine(model, hw, cfg, device)
    from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine

    return ShardedPropagationEngine(model, hw, cfg, mesh)


def _make_fuser(streams: Sequence[Stream], out_hw: Tuple[int, int], probability: bool, reduction: str):
    """The fusion tail: per-stream (N, D, P) scores → (N, H, W) uint8 masks,
    on the scores' device, one frame at a time (a frame's full-resolution
    (H, W, D) maps are the largest tensors it makes)."""
    flip_axis = {"h": 1, "v": 0}

    def fuse_frame(preds):
        full = []
        for s, pred in zip(streams, preds):
            e = s.engine
            if probability:
                x = nearest_resize(pred.T.reshape(e.hd, e.wd, -1), out_hw)  # (H, W, D)
            else:
                mask = torch.argmax(pred, dim=0).reshape(e.hd, e.wd, 1)
                x = nearest_resize(mask, out_hw)[:, :, 0]
            if s.pred_flip is not None:
                x = torch.flip(x, dims=(flip_axis[s.pred_flip],))
            full.append(x)
        fused = full[0]
        if probability:
            for x in full[1:]:
                fused = REDUCTIONS[reduction](fused, x)
            # the reference quantises the fused map to fp16 before the final
            # argmax (``inference_utils.py:180-182``); kept for tie-breaking
            return torch.argmax(fused.half(), dim=-1).to(torch.uint8)
        for x in full[1:]:
            fused = torch.maximum(fused, x)
        return fused.to(torch.uint8)

    def fuse(*preds):
        return torch.stack([fuse_frame([p[i] for p in preds]) for i in range(preds[0].shape[0])])

    return fuse


def run_streams(
    dataset,
    annotation_dir,
    save_dir,
    make_streams: Callable[[Tuple[int, int], int], List[Stream]],
    probability: bool = False,
    reduction: str = "mean",
    progress: Optional[Callable[[], None]] = None,
) -> None:
    """Per-frame loop over an ordered (video-grouped) dataset.
    ``make_streams(frame_hw, num_classes)`` builds the streams; they are
    rebuilt when the resolution changes or a video has more objects than
    the current class budget. Each chunk's frames are stacked in span
    ``cli.stack``."""
    chunk_n = chunk_len()
    streams: List[Stream] = []
    fuser = None
    drain = MaskDrain()
    pending: List = []  # buffered dataset items
    palette = None
    last_video = None
    frame_idx = 0
    out_hw = None

    def frames_of(s: Stream) -> List[np.ndarray]:
        return [it if s.input_idx is None else it[s.input_idx] for it in pending]

    def run_pending():
        nonlocal frame_idx
        if not pending:
            return
        n = len(pending)
        if len(streams) == 1:
            s = streams[0]
            with span("cli.stack"):
                frames = np.stack(frames_of(s))
            masks, s.state = s.engine.step_chunk_small(frames, s.state, frame_idx)

            def convert(m=masks, hw=out_hw):
                a = m.cpu().numpy()
                if a.shape[1:3] != tuple(hw):
                    a = nearest_resize_host(a, hw, hw_axes=(1, 2))
                return list(a)

            drain.submit(convert)
        else:
            preds = []
            for s in streams:
                frames = frames_of(s)
                with span("cli.stack"):
                    batch = np.stack(frames + [frames[-1]] * (chunk_n - n))
                scores, s.state = s.engine.step_chunk_scores(batch, s.state, frame_idx)
                preds.append(scores[:n])
            masks = fuser(*preds)
            drain.submit(lambda m=masks: list(m.cpu().numpy()))
        frame_idx += n
        pending.clear()

    def flush():
        if last_video is None:
            return
        run_pending()
        masks = [m for group in drain.drain() for m in group]
        if masks:
            save_predictions(masks, palette, save_dir, last_video)

    try:
        for item, video in prefetch_dataset(dataset):
            if video != last_video and last_video is not None:
                flush()
                frame_idx = 0
            if frame_idx == 0:
                out_hw = (item[0] if isinstance(item, tuple) else item).shape[:2]
                annotation = first_annotation_path(annotation_dir, video)
                label, d, palette = load_annotation(annotation)
                budget = streams[0].engine.cfg.num_classes if streams else 0
                if not streams or (streams[0].engine.h, streams[0].engine.w) != tuple(out_hw) or d > budget:
                    streams = make_streams(tuple(out_hw), max(d, budget))
                    fuser = _make_fuser(streams, out_hw, probability, reduction)
                copy_first_annotation(annotation, save_dir, video)
                for s in streams:
                    frame = item if s.input_idx is None else item[s.input_idx]
                    s.state = s.engine.start_video(frame, _flip_label(label, s.label_flip))
                frame_idx = 1
            else:
                pending.append(item)
                if len(pending) == chunk_n:
                    run_pending()
            last_video = video
            if progress:
                progress()
        flush()
    finally:
        drain.close()


# ---- strategy entry points -------------------------------------------------


def inference_single(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, device, progress=None,
                     mesh=None) -> None:
    """Reference ``inference_utils.py:23-87``: one stream, argmax of the
    propagated labels. Every strategy takes ``mesh`` (``--bank-shards``)."""

    def make(hw, d):
        return [Stream(_make_engine(model, hw, _with_budget(cfg, d), device, mesh), None)]

    run_streams(dataset, annotation_dir, save_dir, make, cfg.probability_propagation, "mean", progress)


def inference_single_sharded(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, mesh,
                             progress=None) -> None:
    """``single`` with the bank sharded over the mesh's ``model`` axis; an
    alias of :func:`inference_single` with ``mesh``, as in the JAX package."""
    inference_single(dataset, annotation_dir, save_dir, model, cfg, mesh.devices[0][0], progress, mesh=mesh)


def _inference_flip(dataset, annotation_dir, save_dir, model, cfg, device, how, reduction, progress, mesh=None):
    """One engine, two streams: the frames and their flip (``how``), whose
    labels are flipped in and whose predictions are flipped back."""

    def make(hw, d):
        e = _make_engine(model, hw, _with_budget(cfg, d), device, mesh)
        return [Stream(e, 0), Stream(e, 1, label_flip=how, pred_flip=how)]

    run_streams(dataset, annotation_dir, save_dir, make, cfg.probability_propagation, reduction, progress)


def inference_hor_flip(dataset, annotation_dir, save_dir, model, cfg, device, reduction="mean", progress=None,
                       mesh=None):
    """Reference ``inference_utils.py:90-193``."""
    _inference_flip(dataset, annotation_dir, save_dir, model, cfg, device, "h", reduction, progress, mesh)


def inference_ver_flip(dataset, annotation_dir, save_dir, model, cfg, device, reduction="mean", progress=None,
                       mesh=None):
    """Reference ``inference_utils.py:196-299`` (un-flipped vertically: see
    the module docstring)."""
    _inference_flip(dataset, annotation_dir, save_dir, model, cfg, device, "v", reduction, progress, mesh)


def inference_2_scale(dataset, annotation_dir, save_dir, model, cfg, device, scale, reduction="mean",
                      flip_pred=False, progress=None, mesh=None):
    """Reference ``inference_utils.py:302-408``: a second engine at
    ``ceil((H, W) · scale)`` (``flip_pred=True`` is ``hor-2-scale``, whose
    second stream is mirrored)."""

    def make(hw, d):
        c = _with_budget(cfg, d)
        hw2 = (int(np.ceil(hw[0] * scale)), int(np.ceil(hw[1] * scale)))
        flip = "h" if flip_pred else None
        return [
            Stream(_make_engine(model, hw, c, device, mesh), 0),
            Stream(_make_engine(model, hw2, c, device, mesh), 1, label_flip=flip, pred_flip=flip),
        ]

    run_streams(dataset, annotation_dir, save_dir, make, cfg.probability_propagation, reduction, progress)


def inference_multimodel(dataset, annotation_dir, save_dir, model, additional_model, cfg, device,
                         reduction="mean", progress=None, mesh=None):
    """Reference ``inference_utils.py:411-511``: the same frames through two
    networks."""

    def make(hw, d):
        c = _with_budget(cfg, d)
        return [
            Stream(_make_engine(model, hw, c, device, mesh), None),
            Stream(_make_engine(additional_model, hw, c, device, mesh), None),
        ]

    run_streams(dataset, annotation_dir, save_dir, make, cfg.probability_propagation, reduction, progress)


def inference_3_scale(dataset, annotation_dir, save_dir, model, cfg, device, scale, progress=None,
                      mesh=None) -> None:
    """Reference ``inference_utils.py:514-595``: three sequential passes over
    the whole dataset at input scales [0.9, 1.0, ``scale``] (nearest rescale
    of the frames on the host), each pass's masks upsampled to the
    reference's hard-coded (480, 910) (``inference_utils.py:574``, kept for
    output parity), then the per-pixel max over the passes."""
    out_hw = (480, 910)
    predictions: Dict[str, List[List[np.ndarray]]] = {}
    palettes: Dict[str, list] = {}
    chunk_n = chunk_len()
    for pass_idx, sc in enumerate([0.9, 1.0, scale]):
        engine: Optional[PropagationEngine] = None
        state = None
        pending: List[np.ndarray] = []
        last_video = None
        frame_idx = 0
        drain = MaskDrain()

        def run_pending():
            nonlocal frame_idx, state
            if not pending:
                return
            masks, state = engine.step_chunk_small(np.stack(pending), state, frame_idx)
            drain.submit(lambda m=masks: list(nearest_resize_host(m.cpu().numpy(), out_hw, hw_axes=(1, 2))))
            frame_idx += len(pending)
            pending.clear()

        def flush():
            if last_video is None:
                return
            run_pending()
            masks = [m for group in drain.drain() for m in group]
            if masks:
                predictions.setdefault(last_video, []).append(masks)

        try:
            for item, video in prefetch_dataset(dataset):
                frame = item[0] if isinstance(item, tuple) else item
                h, w = frame.shape[:2]
                hs, ws = int(np.ceil(h * sc)), int(np.ceil(w * sc))
                # nearest rescale of the uint8 frame; it commutes with the
                # normalisation the reference does first (:526)
                frame = frame[(np.arange(hs) * h) // hs][:, (np.arange(ws) * w) // ws]
                if video != last_video and last_video is not None:
                    flush()
                    frame_idx = 0
                if frame_idx == 0:
                    annotation = first_annotation_path(annotation_dir, video)
                    label, d, palettes[video] = load_annotation(annotation)
                    budget = engine.cfg.num_classes if engine is not None else 0
                    if engine is None or (engine.h, engine.w) != (hs, ws) or d > budget:
                        engine = _make_engine(model, (hs, ws), _with_budget(cfg, max(d, budget)), device, mesh)
                    if pass_idx == 0:
                        copy_first_annotation(annotation, save_dir, video)
                    # first-frame labels go to this pass's scaled grid
                    # (``predict.py:146-153``)
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

    logger.info("Fusing 3-scale predictions.")
    for video, passes in predictions.items():
        fused = [np.maximum(np.maximum(a, b), c) for a, b, c in zip(*passes)]
        save_predictions(fused, palettes[video], save_dir, video)
