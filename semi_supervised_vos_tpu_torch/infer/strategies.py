"""The seven inference strategies (reference ``src/utils/inference_utils.py``):
``single`` (:23), ``hor-flip`` (:90), ``vert-flip`` (:196), ``2-scale`` /
``hor-2-scale`` (:302), ``multimodel`` (:411) and ``3-scale`` (:514). Each
runs one to three propagation streams and fuses their masks:

* label propagation (default): per stream a nearest upsample of the argmax,
  then the elementwise **max of class indices** (``inference_utils.py:184``);
* ``--probability``: per-stream upsampled score maps combined with the
  ``maximum`` / ``minimum`` / ``mean`` reduction (``:18-20``), rounded to
  float16 as the reference's ``.cpu().half()`` does, then the argmax.

A strategy is a description (:func:`strategy_passes`): its passes, each a
list of streams, each stream naming its network, its element of the dataset
item, its first-frame label flip, its prediction unflip and its input scale.
Two runners drive it: :func:`inference` here, one video at a time through
:func:`run_streams`, and ``infer/batched.py::inference_batched``, videos in
lockstep. Both fuse through :func:`fuse`, and both run a strategy's passes
through :func:`run_strategy`, which is where 3-scale's three passes meet.

Frames buffer into chunks of ``SVOS_CHUNK`` (default 8). With one stream a
chunk is one batched encode plus a sequential propagation on the device
(``PropagationEngine.step_chunk_small``); masks come back at feature
resolution once per chunk and are nearest-upsampled on the host by the
drain worker (argmax commutes with nearest upsampling, so this equals the
reference's upsample-then-argmax). With several streams each stream turns
the chunk into raw (N, D, P) scores (``step_chunk_scores``; the final
partial chunk is padded by repeating its last frame: the video is over, so
what that does to the bank is never read), :func:`fuse` runs on the device,
and one uint8 tensor per chunk goes to the host.

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
import threading
from collections import defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

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

# 3-scale's passes are saved at the reference's hard-coded size
# (``inference_utils.py:574``), kept for output parity
THREE_SCALE_HW = (480, 910)


def chunk_len() -> int:
    """Frames per device chunk (``SVOS_CHUNK``, clamped to >= 1)."""
    return max(1, int(os.environ.get("SVOS_CHUNK", "8")))


@dataclasses.dataclass
class Stream:
    """One propagation stream of a strategy; without an engine, its
    description, to which a runner gives one."""

    engine: Optional[PropagationEngine]
    input_idx: Optional[int] = None  # index into the dataset item tuple (None = whole item)
    label_flip: Optional[str] = None  # flip of the first-frame labels: 'h' | 'v'
    pred_flip: Optional[str] = None  # flip of the full-res prediction: 'h' | 'v'
    state: object = None
    # the stream runs at ceil(frame size x scale); an input the dataset did
    # not make at that size is rescaled (nearest) on the host
    scale: Optional[float] = None
    network: int = 0  # 0: the main network, 1: the additional one


def strategy_passes(strategy: str, scale: float) -> List[List[Stream]]:
    """The streams of each of ``strategy``'s passes. Every strategy is one
    pass but ``3-scale``: three one-stream passes over the whole dataset at
    input scales [0.9, 1.0, ``scale``]. The dataset's items hold the second
    stream's input for the flips and the 2-scales (``data/davis.py``). Every
    stream starts from the full-resolution first-frame labels, flipped as its
    input, which its engine takes to its own grid (the reference's
    ``get_labels``, ``predict.py:136-153``)."""
    passes = {
        "single": [[Stream(None)]],
        "hor-flip": [[Stream(None, 0), Stream(None, 1, "h", "h")]],
        "vert-flip": [[Stream(None, 0), Stream(None, 1, "v", "v")]],
        "2-scale": [[Stream(None, 0), Stream(None, 1, scale=scale)]],
        "hor-2-scale": [[Stream(None, 0), Stream(None, 1, "h", "h", scale=scale)]],
        "multimodel": [[Stream(None), Stream(None, network=1)]],
        "3-scale": [[Stream(None, scale=sc)] for sc in (0.9, 1.0, scale)],
    }
    if strategy not in passes:
        raise ValueError(f"unknown inference strategy {strategy!r}")
    return passes[strategy]


def frame_of(item) -> np.ndarray:
    """A dataset item's frame (the first element of a pair)."""
    return item[0] if isinstance(item, tuple) else item


def stream_hw(s: Stream, frame_hw) -> Tuple[int, int]:
    """The stream's resolution for frames of ``frame_hw``."""
    if s.scale is None:
        return tuple(frame_hw)
    return int(np.ceil(frame_hw[0] * s.scale)), int(np.ceil(frame_hw[1] * s.scale))


def stream_frame(s: Stream, item) -> np.ndarray:
    """The stream's input frame from a dataset item."""
    x = item if s.input_idx is None else item[s.input_idx]
    hs, ws = stream_hw(s, frame_of(item).shape[:2])
    h, w = x.shape[:2]
    if (h, w) == (hs, ws):
        return x
    # nearest rescale of the uint8 frame; it commutes with the normalisation
    # the reference does first (``inference_utils.py:526``)
    return x[(np.arange(hs) * h) // hs][:, (np.arange(ws) * w) // ws]


def flip_label(label: np.ndarray, how: Optional[str]) -> np.ndarray:
    """A first-frame label map flipped as its stream's input ('h' | 'v')."""
    if how == "h":
        return np.ascontiguousarray(label[:, ::-1])
    if how == "v":
        return np.ascontiguousarray(label[::-1, :])
    return label


def with_budget(cfg: EngineConfig, num_classes: int) -> EngineConfig:
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


def _full_res(score: torch.Tensor, grid, flip: Optional[str], out_hw, probability: bool) -> torch.Tensor:
    """One stream's (..., D, P) scores at ``out_hw``, unflipped: the
    (..., H, W, D) maps in probability mode, else the (..., H, W) argmax,
    taken at feature resolution (it commutes with the nearest upsample).
    The unflip comes after the upsample: nearest upsampling is not
    flip-equivariant on grids that do not divide the frame."""
    lead = tuple(score.shape[:-2])
    if probability:
        x, h_axis = score.transpose(-1, -2).reshape(lead + tuple(grid) + (-1,)), -3
    else:
        x, h_axis = torch.argmax(score, dim=-2).view(lead + tuple(grid)), -2
    x = nearest_resize(x, out_hw, hw_axes=(h_axis, h_axis + 1))
    if flip is not None:
        x = torch.flip(x, dims=({"v": h_axis, "h": h_axis + 1}[flip],))
    return x


def fuse(scores: Sequence[torch.Tensor], grids, flips, out_hw, probability: bool = False,
         reduction: str = "mean") -> torch.Tensor:
    """The fusion of streams: each stream's (L, ..., D, P) float32 scores,
    on its (hd, wd) feature grid and with its prediction unflip (``grids``,
    ``flips``), → (L, ..., h, w) uint8 masks on the scores' device. Label
    mode takes the max of the streams' class indices; probability mode the
    ``reduction`` of their maps, in float16 before the argmax as the
    reference's ``.cpu().half()`` (``inference_utils.py:180-182``); one
    stream is its own argmax in both.

    Where every stream shares one grid and none flips, the masks stay at
    feature resolution (h, w = hd, wd) for the caller to upsample: the
    argmax, max and reduction commute with the nearest upsample. Otherwise
    they are at ``out_hw``, fused one index of L at a time (a step's
    full-resolution maps are the largest tensors this makes)."""

    def combine(xs, d_axis):
        out = xs[0]
        if not probability:  # class index maps
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        for x in xs[1:]:
            out = REDUCTIONS[reduction](out, x)
        return torch.argmax(out.half() if len(xs) > 1 else out, dim=d_axis)

    if len(set(map(tuple, grids))) == 1 and not any(flips):
        m = combine(scores if probability else [torch.argmax(s, dim=-2) for s in scores], -2)
        return m.view(tuple(m.shape[:-1]) + tuple(grids[0])).to(torch.uint8)
    out = torch.empty(tuple(scores[0].shape[:-2]) + tuple(out_hw), dtype=torch.uint8, device=scores[0].device)
    for i in range(out.shape[0]):
        out[i] = combine([_full_res(s[i], g, f, out_hw, probability) for s, g, f in zip(scores, grids, flips)], -1)
    return out


def host_masks(masks: torch.Tensor, out_hw) -> np.ndarray:
    """Device masks at full or feature resolution → host masks at
    ``out_hw`` (the nearest upsample on the host)."""
    a = masks.cpu().numpy()
    return a if a.shape[-2:] == tuple(out_hw) else nearest_resize_host(a, out_hw, hw_axes=(-2, -1))


def run_strategy(run_pass: Callable, strategy: str, scale: float, save_dir) -> None:
    """Run ``strategy``'s passes through ``run_pass(streams, sink=None,
    out_hw=None)``, a runner of one video at a time or of lockstep groups.
    A runner without a sink writes each video's PNGs; 3-scale
    (``inference_utils.py:514-595``) gives each of its passes a sink that
    keeps the masks, upsampled to ``THREE_SCALE_HW``, and writes the
    per-pixel max over the passes at the end."""
    passes = strategy_passes(strategy, scale)
    if len(passes) == 1:
        run_pass(passes[0])
        return
    fused, palettes, lock = defaultdict(dict), {}, threading.Lock()

    def keep(video, t, mask, palette):  # called from a lockstep runner's writer threads
        with lock:
            palettes[video] = palette
            prev = fused[video].get(t)
            fused[video][t] = mask if prev is None else np.maximum(prev, mask)

    for streams in passes:
        run_pass(streams, keep, THREE_SCALE_HW)
    logger.info("Fusing 3-scale predictions.")
    for video, masks in fused.items():
        save_predictions([masks[t] for t in sorted(masks)], palettes[video], save_dir, video)


def run_streams(
    dataset,
    annotation_dir,
    save_dir,
    make_streams: Callable[[Tuple[int, int], int], List[Stream]],
    probability: bool = False,
    reduction: str = "mean",
    progress: Optional[Callable[[], None]] = None,
    sink: Optional[Callable] = None,
    out_hw: Optional[Tuple[int, int]] = None,
) -> None:
    """Per-frame loop over an ordered (video-grouped) dataset.
    ``make_streams(frame_hw, num_classes)`` builds the streams; they are
    rebuilt when a stream's resolution changes or a video has more objects
    than the current class budget. Each chunk's frames are stacked in span
    ``cli.stack``. Each video's masks, at its frame size or ``out_hw``, go
    to ``save_predictions`` or, given a sink, to ``sink(video, t, mask,
    palette)`` for each frame t >= 1."""
    chunk_n = chunk_len()
    streams: List[Stream] = []
    drain = MaskDrain()
    pending: List = []  # buffered dataset items
    palette = None
    last_video = None
    frame_idx = 0
    hw = None

    def run_pending():
        nonlocal frame_idx
        if not pending:
            return
        n = len(pending)
        if len(streams) == 1:
            s = streams[0]
            frames = [stream_frame(s, it) for it in pending]
            with span("cli.stack"):
                batch = np.stack(frames)
            masks, s.state = s.engine.step_chunk_small(batch, s.state, frame_idx)
        else:
            preds = []
            for s in streams:
                frames = [stream_frame(s, it) for it in pending]
                with span("cli.stack"):
                    batch = np.stack(frames + [frames[-1]] * (chunk_n - n))
                scores, s.state = s.engine.step_chunk_scores(batch, s.state, frame_idx)
                preds.append(scores[:n])
            masks = fuse(preds, [(s.engine.hd, s.engine.wd) for s in streams], [s.pred_flip for s in streams], hw,
                         probability, reduction)
        drain.submit(lambda m=masks, hw=hw: list(host_masks(m, hw)))
        frame_idx += n
        pending.clear()

    def flush():
        if last_video is None:
            return
        run_pending()
        masks = [m for group in drain.drain() for m in group]
        if masks and sink is None:
            save_predictions(masks, palette, save_dir, last_video)
        elif masks:
            for t, mask in enumerate(masks, 1):
                sink(last_video, t, mask, palette)

    try:
        for item, video in prefetch_dataset(dataset):
            if video != last_video and last_video is not None:
                flush()
                frame_idx = 0
            if frame_idx == 0:
                frame_hw = tuple(frame_of(item).shape[:2])
                hw = out_hw or frame_hw
                annotation = first_annotation_path(annotation_dir, video)
                label, d, palette = load_annotation(annotation)
                budget = streams[0].engine.cfg.num_classes if streams else 0
                if not streams or d > budget or any((s.engine.h, s.engine.w) != stream_hw(s, frame_hw)
                                                    for s in streams):
                    streams = make_streams(frame_hw, max(d, budget))
                copy_first_annotation(annotation, save_dir, video)
                for s in streams:
                    s.state = s.engine.start_video(stream_frame(s, item), flip_label(label, s.label_flip))
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


# ---- entry points ----------------------------------------------------------


def inference(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, device, strategy: str = "single",
              reduction: str = "mean", progress=None, mesh=None, additional_model=None, scale: float = 1.15) -> None:
    """Any of the seven strategies, one video at a time: one engine per
    (network, resolution) of the strategy's streams (hor-flip's two streams
    share one), with ``mesh`` (``--bank-shards``) bank-sharded."""
    networks = (model, additional_model)

    def run_pass(specs, sink=None, out_hw=None):
        def make(hw, d):
            c = with_budget(cfg, d)
            engines, streams = {}, []
            for s in specs:
                key = (s.network, stream_hw(s, hw))
                if key not in engines:
                    engines[key] = _make_engine(networks[s.network], key[1], c, device, mesh)
                streams.append(dataclasses.replace(s, engine=engines[key]))
            return streams

        run_streams(dataset, annotation_dir, save_dir, make, cfg.probability_propagation, reduction, progress,
                    sink, out_hw)

    run_strategy(run_pass, strategy, scale, save_dir)


def inference_single(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, device, progress=None,
                     mesh=None) -> None:
    """Reference ``inference_utils.py:23-87``: one stream, argmax of the
    propagated labels."""
    inference(dataset, annotation_dir, save_dir, model, cfg, device, "single", progress=progress, mesh=mesh)


def inference_single_sharded(dataset, annotation_dir, save_dir, model, cfg: EngineConfig, mesh,
                             progress=None) -> None:
    """``single`` with the bank sharded over the mesh's ``model`` axis; an
    alias of :func:`inference_single` with ``mesh``, as in the JAX package."""
    inference_single(dataset, annotation_dir, save_dir, model, cfg, mesh.devices[0][0], progress, mesh=mesh)
