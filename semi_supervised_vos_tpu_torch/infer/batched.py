"""Lockstep multi-video inference (``--video-batch``): the PyTorch
counterpart of ``semi_supervised_vos_tpu/infer/batched.py``.

The single engine propagates one frame of one video at a time. Here B
same-resolution streams ("lanes": videos x the strategy's streams) advance
in lockstep: one encode over a chunk of (N, B) frames, then per step one
propagation over all B lanes and one in-place write of the step's (B, P, ·)
slot into slot-major banks. On the card a step is **one** launch of the
bank kernel (``ops/affinity.py::affinity_from_bank_batched``) for all lanes.
That kernel reads the (B, P, C) targets directly and its wrapper folds the
temperature in with the value chain of the JAX kernel's own fallback
(float32 x T, then bf16), so the JAX engine's ``_transpose_targets`` (a
pre-transposed target operand kept out of its scan) has no counterpart. On
the CPU each lane runs the single engine's golden path, as the JAX engine's
``vmap`` does.

Videos are grouped by resolution and run in sorted chunks of
``video_batch`` videos; a chunk is padded to its longest video (shorter
videos repeat their last frame and those outputs are dropped) and the last
device chunk to a whole chunk. Per-video state never mixes and the frame
schedule is shared, so each video's masks are the single engine's. On the
host, rows of B frames are decoded ahead on a thread pool, and each
chunk's PNGs are written on another while later chunks run.

``_hbm_lanes_cap`` caps the lanes on the card, and the frames of one encode
call, by a lane-pixel budget measured on the card at two resolutions, per
network and compute dtype (a float32 bank doubles its feature bytes); with
a mesh the runners scale it by the distinct cards that encode
(``_mesh_data_chips``).

With a mesh, :func:`_make_engine` returns ``parallel/batched_dp.py``'s
engine, which spreads the lanes over the mesh's data rows and, with a
``model`` axis > 1 (JAX ``bank_axis`` / ``bank_shards``), shards every
lane's bank rows over each row's devices
(``parallel/engine_sharded.py::BankShards``, whose ``local_rows`` is JAX
``_local_rows`` and whose ``propagate`` is JAX ``_propagate_bank_sharded``:
one stats-mode bank-kernel launch per shard for all B lanes, then the
combine). ``_flip2d`` is ``strategies._flip_label``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.data.loader import prefetch
from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
from semi_supervised_vos_tpu_torch.infer.engine import BankState, PropagationEngine, compute_dtype, grouped_map
from semi_supervised_vos_tpu_torch.infer.strategies import REDUCTIONS, _flip_label, _with_budget, chunk_len
from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
from semi_supervised_vos_tpu_torch.ops.onehot import index_to_onehot
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize, nearest_resize_host
from semi_supervised_vos_tpu_torch.utils.image import (
    copy_first_annotation,
    first_annotation_path,
    load_annotation,
    save_prediction,
    save_predictions,
)
from semi_supervised_vos_tpu_torch.utils import profiling
from semi_supervised_vos_tpu_torch.utils.logging import logger
from semi_supervised_vos_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LaneFusion:
    """Multi-stream strategies under lockstep batching.

    Each video occupies ``len(pred_flips)`` consecutive lanes (hor-flip:
    lane 0 the frames, lane 1 their mirror). Label histories stay per lane,
    as the reference's per-stream histories (``inference_utils.py:90-193``);
    only the saved output fuses the lanes: per-lane full-resolution unflip,
    then the max of class indices (label mode) or the ``reduction`` of the
    probability maps and a float16 argmax (probability mode).
    """

    pred_flips: Tuple[Optional[str], ...]  # per lane: None | 'h' | 'v'
    probability: bool = False
    reduction: str = "mean"

    @property
    def lanes(self) -> int:
        return len(self.pred_flips)


def _unflip(x: torch.Tensor, how: Optional[str], h_axis: int, w_axis: int) -> torch.Tensor:
    if how == "h":
        return torch.flip(x, dims=(w_axis,))
    if how == "v":
        return torch.flip(x, dims=(h_axis,))
    return x


class BatchedPropagationEngine(PropagationEngine):
    """Lockstep propagation for B same-resolution streams.

    Banks are slot-major, (capacity, B, P, C) features in the compute dtype
    and (capacity, B, P, D_pad) labels (bf16 on the card, float32 on the
    CPU), the layout the bank kernel takes; each step overwrites its slot in place. With
    ``fusion`` set, ``batch`` counts lanes (videos x streams) and
    :meth:`step_chunk` returns one fused mask per video, else one per lane.
    The encoder, the write-back and the chunk loops are the single
    engine's, run on a leading lane axis.
    """

    def __init__(self, model, frame_hw: Tuple[int, int], batch: int, cfg, device,
                 fusion: Optional[LaneFusion] = None, table=None):
        if fusion is not None and batch % fusion.lanes:
            raise ValueError(f"batch {batch} is not a multiple of the {fusion.lanes} lanes a video takes")
        super().__init__(model, frame_hw, cfg, device, table)
        self.b = batch
        self.fusion = fusion

    def init_state(self) -> BankState:
        cfg = self.cfg
        return BankState(
            feats=torch.zeros((cfg.capacity, self.b, self.p, cfg.feature_dim), dtype=self.dtype, device=self.device),
            labels=torch.zeros((cfg.capacity, self.b, self.p, self.d_pad), dtype=self.label_dtype, device=self.device),
        )

    def _encode_chunk(self, frames_u8) -> torch.Tensor:
        """(N, B, H, W, 3) frames → (N, B, P, C): g steps (g·B images) per
        encode call, g·B at most the card's lane cap for this frame size."""

        def enc(fb):
            g = fb.shape[0]
            return self.encode(fb.reshape((g * self.b,) + fb.shape[2:])).view(g, self.b, self.p, -1)

        cap = _hbm_lanes_cap((self.h, self.w), self.model.model, self.dtype)
        return grouped_map(enc, frames_u8, max(1, cap // self.b))

    def _propagate(self, targets: torch.Tensor, state: BankState, frame_idx: int) -> torch.Tensor:
        """(B, P, C) targets → (B, num_classes, P) float32 scores."""
        if not self.on_card:
            return torch.stack([
                PropagationEngine._propagate(self, targets[b], BankState(state.feats[:, b], state.labels[:, b]),
                                             frame_idx)
                for b in range(self.b)
            ])
        from semi_supervised_vos_tpu_torch.ops.affinity import affinity_from_bank_batched

        cfg = self.cfg
        idx, valid, dense = sample_frames(frame_idx, cfg.frame_range, cfg.ref_num, cfg.continuous_frame)
        pred = affinity_from_bank_batched(
            state.feats, state.labels, targets.float(), idx % cfg.capacity,
            feature_hw=(self.hd, self.wd), temperature=cfg.temperature,
            valid=valid, dense=dense, sigma_1=cfg.sigma_1, sigma_2=cfg.sigma_2,
            spatial=not cfg.probability_propagation,
        )
        return pred[:, : cfg.num_classes]

    def _finalize(self, pred: torch.Tensor) -> torch.Tensor:
        """(B, D, P) scores → (lanes or videos, H, W) uint8 masks: argmax at
        feature resolution (it commutes with the nearest upsample), upsample,
        THEN unflip (nearest upsampling is not flip-equivariant on grids that
        do not divide the frame), then fuse the lanes of each video."""
        fusion = self.fusion
        # one lane: the saved mask is the argmax of the scores in both modes
        if fusion is None or fusion.lanes == 1:
            masks = torch.argmax(pred, dim=1).view(self.b, self.hd, self.wd)
            return nearest_resize(masks, (self.h, self.w), hw_axes=(1, 2)).to(torch.uint8)
        lanes = fusion.lanes
        v = self.b // lanes
        if fusion.probability:
            x = pred.transpose(1, 2).reshape(self.b, self.hd, self.wd, -1)
            x = nearest_resize(x, (self.h, self.w), hw_axes=(1, 2)).view(v, lanes, self.h, self.w, -1)
            fused = None
            for lane, flip in enumerate(fusion.pred_flips):
                xl = _unflip(x[:, lane], flip, h_axis=1, w_axis=2)
                fused = xl if fused is None else REDUCTIONS[fusion.reduction](fused, xl)
            # float16 before the argmax, as the reference's ``.cpu().half()``
            # (``inference_utils.py:180-182``)
            return torch.argmax(fused.half(), dim=-1).to(torch.uint8)
        masks = torch.argmax(pred, dim=1).view(self.b, self.hd, self.wd)
        masks = nearest_resize(masks, (self.h, self.w), hw_axes=(1, 2)).view(v, lanes, self.h, self.w)
        fused = None
        for lane, flip in enumerate(fusion.pred_flips):
            ml = _unflip(masks[:, lane], flip, h_axis=1, w_axis=2)
            fused = ml if fused is None else torch.maximum(fused, ml)
        return fused.to(torch.uint8)

    @torch.no_grad()
    def start_videos(self, frames_u8: np.ndarray, labels_full: np.ndarray) -> BankState:
        """Frame 0 of every lane, (B, H, W, 3) frames and (B, H, W) labels: a
        fresh bank holding their features and downsampled one-hot labels."""
        with span("engine.start", new_id=True):
            state = self.init_state()
            label = torch.as_tensor(np.asarray(labels_full, np.int64), device=self.device)
            small = nearest_resize(label, (self.hd, self.wd), hw_axes=(1, 2)).reshape(self.b, self.p)
            self._write(state, 0, self.encode(frames_u8), index_to_onehot(small, self.d_pad, self.label_dtype))
        return state

    @torch.no_grad()
    def step(self, frames_u8: np.ndarray, state: BankState, frame_idx: int):
        """One lockstep step on (B, H, W, 3) frames → (masks, state), the
        masks as :meth:`_finalize` gives them."""
        return self._finalize(self._step(self.encode(frames_u8), state, frame_idx)), state

    @torch.no_grad()
    def step_chunk(self, frames_u8: np.ndarray, state: BankState, start_idx: int):
        """(N, B, H, W, 3) frames → ((N, lanes or videos, H, W) uint8 masks on
        the device, state). The full-resolution fusion runs one step at a
        time: a step's (B, H, W, D) float32 maps are the largest tensors it
        makes."""
        with span("engine.step", new_id=True):
            feats = self._encode_chunk(frames_u8)
            profiling.count("engine.frames", feats.shape[:-2].numel())
            out = None
            for i in range(feats.shape[0]):
                masks = self._finalize(self._step(feats[i], state, start_idx + i))
                if out is None:
                    out = masks.new_empty((feats.shape[0],) + tuple(masks.shape))
                out[i] = masks
        return out, state

    # step_chunk_small ((N, B, hd, wd) uint8 feature-resolution masks, for
    # one-lane engines) and step_chunk_scores ((N, B, D, P) float32 scores)
    # are the single engine's, on the lane axis.


# per-strategy lane wiring: (dataset item index | None, first-frame label
# flip, full-resolution prediction unflip) per lane, as the Streams of
# ``strategies.py`` for the same strategies
_STRATEGY_LANES = {
    "single": ((None, None, None),),
    "hor-flip": ((0, None, None), (1, "h", "h")),
    "vert-flip": ((0, None, None), (1, "v", "v")),
}

BATCHABLE_STRATEGIES = tuple(_STRATEGY_LANES)


# The card's lockstep envelope in lane-grid pixels (lanes x P), from two
# anchors measured by ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 (power
# limit 700 W, 85.0 GB to PyTorch): one chunk (start + 8 steps) at the cap,
# where an encode call takes one step of every lane. Each budget is the
# lanes that filled 70 % of the card at the rate measured then, which
# leaves room under the 85 % that phases 10d and 12d check. Between the
# anchors the budget is interpolated in log space (a power law through
# both; the activations and the bank grow at other rates with the frame);
# outside them it clamps.
#   * resnet18 / resnet50 / resnet101 (1024 channels at most), phase 10d:
#     0.2555 GB a lane at 480p (P 6420: the 162 MB ring bank, one frame of
#     encoder activations, the chunk's frames and features) and 1.289 GB at
#     1080p (P 32400); 232 and 46 lanes. The float32 stem and 1x1 results
#     of the encoder raised them to 0.2719 and 1.372 GB (0.743 of the card
#     at the cap).
#   * facebook (layer4 keeps 2048 channels at stride 8), phase 12d: 0.3475
#     GB a lane at 480p and 1.754 GB at 1080p; 171 and 33 lanes.
#   * dino_vitb8 (a 768-wide bank, three times the ResNets'; the ViT's
#     activations over 1 + P tokens a frame), ``prof_torch/vit_lanes.py``
#     (one chunk at 24 and at 4 lanes, an encode call taking one step of
#     each): 0.7252 GB a lane at 480p and 3.635 GB at 1080p; 82 and 16 lanes.
#   * float32 features (SVOS_INFER_DTYPE=float32; the bank's features and
#     the encoder's activations double), ``prof_torch/lane_caps.py``:
#     resnet50 0.4727 GB a lane at 480p and 2.384 GB at 1080p, 125 and 24
#     lanes; facebook 0.5710 and 2.882 GB, 104 and 20 lanes (measured at
#     caps of 116 / 22 and 87 / 17 lanes: 0.647 / 0.619 and 0.588 / 0.580 of
#     the card). Phase 14e checks resnet50's.
_HBM_ANCHOR_P_SMALL = 6420
_HBM_ANCHOR_P_LARGE = 32400
_HBM_LANE_PX_SMALL = 232 * _HBM_ANCHOR_P_SMALL
_HBM_LANE_PX_LARGE = 46 * _HBM_ANCHOR_P_LARGE
_HBM_LANE_PX_ARCH = {"facebook": (171 * _HBM_ANCHOR_P_SMALL, 33 * _HBM_ANCHOR_P_LARGE),
                     "dino_vitb8": (82 * _HBM_ANCHOR_P_SMALL, 16 * _HBM_ANCHOR_P_LARGE)}
_HBM_LANE_PX_F32 = (125 * _HBM_ANCHOR_P_SMALL, 24 * _HBM_ANCHOR_P_LARGE)
_HBM_LANE_PX_F32_ARCH = {"facebook": (104 * _HBM_ANCHOR_P_SMALL, 20 * _HBM_ANCHOR_P_LARGE)}


def _hbm_lanes_cap(hw: Tuple[int, int], arch: str = "resnet50", dtype=torch.bfloat16) -> int:
    """Most lockstep lanes per card for this frame size, network and
    compute dtype (see the anchors)."""
    if dtype == torch.float32:
        small, large = _HBM_LANE_PX_F32_ARCH.get(arch, _HBM_LANE_PX_F32)
    else:
        small, large = _HBM_LANE_PX_ARCH.get(arch, (_HBM_LANE_PX_SMALL, _HBM_LANE_PX_LARGE))
    hd, wd = out_spatial(hw[0], hw[1])
    p = hd * wd
    if p <= _HBM_ANCHOR_P_SMALL:
        budget = small
    elif p >= _HBM_ANCHOR_P_LARGE:
        budget = large
    else:
        frac = math.log(p / _HBM_ANCHOR_P_SMALL) / math.log(_HBM_ANCHOR_P_LARGE / _HBM_ANCHOR_P_SMALL)
        budget = small * (large / small) ** frac
    return max(1, int(budget) // p)


def _clamp_video_batch(video_batch: int, lanes: int, *hws, n_chips: int = 1, archs=("resnet50",),
                       dtype=torch.bfloat16) -> int:
    """Videos per group such that every card's lanes stay inside the
    envelope of every engine resolution and network involved (``archs``:
    the networks' names; multimodel's wider one governs) at the compute
    ``dtype``: the per-card cap first (each card would carry ceil(vb /
    n_chips) x lanes lanes), then scaled by the card count; logs when it
    bites."""
    governing = min(((hw, arch) for hw in hws for arch in archs), key=lambda k: _hbm_lanes_cap(*k, dtype))
    per_chip_videos = max(1, _hbm_lanes_cap(*governing, dtype) // lanes)
    vb = max(1, min(video_batch, per_chip_videos * max(n_chips, 1)))
    if vb < video_batch:
        logger.info(
            f"video-batch {video_batch} exceeds the card's lane envelope at {governing[0]} for {governing[1]} "
            f"({per_chip_videos} video(s) x {lanes} lanes per card over {n_chips} card(s)); running groups of {vb}."
        )
    return vb


def _mesh_data_chips(mesh) -> int:
    """Distinct cards the lane axis spreads over: the data rows' encoding
    devices (1 without a mesh, and 1 for a virtual mesh that names one card
    in every row, whose lanes all share that card)."""
    return len({row[0] for row in mesh.devices}) if mesh is not None else 1


def _make_engine(model, hw, b, cfg, device, fusion=None, mesh=None):
    """The one-card lockstep engine, or with a mesh of more than one device
    the mesh engine: lanes over the data rows, bank rows over each row's
    devices (``parallel/batched_dp.py``)."""
    if mesh is not None and (mesh.shape["data"] > 1 or mesh.shape["model"] > 1):
        from semi_supervised_vos_tpu_torch.parallel.batched_dp import DataParallelBatchedEngine

        return DataParallelBatchedEngine(model, hw, b, cfg, mesh, fusion)
    return BatchedPropagationEngine(model, hw, b, cfg, device, fusion)


# ---- runners ---------------------------------------------------------------


def _videos(dataset) -> Dict[str, List[int]]:
    """Dataset indices per video, in dataset (video-major) order."""
    per_video: Dict[str, List[int]] = defaultdict(list)
    for i, (_, v) in enumerate(dataset.imgs):
        per_video[dataset.idx_to_class[v]].append(i)
    return per_video


def _groups(per_video, key: Callable[[str], tuple], clamp: Callable[[tuple], int]):
    """(key, sorted chunk of videos, their lengths) for each chunk of each
    group of videos sharing ``key`` (their resolutions); ``clamp(key)``
    gives the group's videos per chunk."""
    groups: Dict[tuple, List[str]] = defaultdict(list)
    for video in per_video:
        groups[key(video)].append(video)
    for k, videos in groups.items():
        vb = clamp(k)
        for start in range(0, len(videos), vb):
            chunk = sorted(videos[start : start + vb])
            yield k, chunk, [len(per_video[v]) for v in chunk]


def _first_labels(chunk, annotation_dir, save_dir, copy: bool = True):
    """Each chunk video's first annotation: (labels, palettes, d_max); the
    annotation is copied into the output tree."""
    labels, palettes, d_max = [], {}, 0
    for v in chunk:
        ann = first_annotation_path(annotation_dir, v)
        label, d, palettes[v] = load_annotation(ann)
        d_max = max(d_max, d)
        if copy:
            copy_first_annotation(ann, save_dir, v)
        labels.append(label)
    return labels, palettes, d_max


# host threads that decode rows of B frames ahead of the device, and as
# many that write the masks' PNGs (PIL releases the interpreter lock in
# both): with one thread each, the PNG writes of a B = 8 group were the
# critical path of a run (``prof_torch/cli_host_split.py`` times them)
HOST_THREADS = 4


def _run_group(chunk, lengths, row, start, step, emit, progress) -> None:
    """Drive one chunk of videos in lockstep (the JAX module's chunk loops
    and ``_drain_collect``).

    ``row(t)`` builds time step t's inputs, decoded ahead on a thread pool;
    ``start(row_0)`` starts the engines; ``step(rows, t, n)`` runs a device
    chunk of ``chunk_len()`` rows, of which the first n are real (the rest
    repeat the last), and returns a closure that fetches the n steps'
    (n, videos, H, W) masks to the host. Those closures run in order on one
    :class:`MaskDrain` worker, which hands each real frame's mask to
    ``emit(video, t, mask)`` (a PNG write, or a store by t) on a pool of
    writer threads; all of it overlaps the decode and the device work that
    the main thread keeps queueing."""
    t_max = max(lengths)
    chunk_n = chunk_len()
    writers = ThreadPoolExecutor(HOST_THREADS)

    def deliver(fetch, t0, n):
        arr = fetch()
        write = profiling.handoff(emit)
        return [writers.submit(write, v, t0 + tt, arr[tt, i])
                for tt in range(n) for i, v in enumerate(chunk) if t0 + tt < lengths[i]]

    rows = prefetch(row, t_max, depth=2 * HOST_THREADS, workers=HOST_THREADS)
    drain = MaskDrain()
    try:
        start(next(rows))
        if progress:
            progress()
        t = 1
        while t < t_max:
            n = min(chunk_n, t_max - t)
            batch = [next(rows) for _ in range(n)]
            fetch = step(batch + [batch[-1]] * (chunk_n - n), t, n)
            if profiling.recording():  # useful over computed: the chunk's steps of each video
                profiling.count("lockstep.lane_steps", chunk_n * len(chunk))
                profiling.count("lockstep.real_lane_steps", sum(max(0, min(n, length - t)) for length in lengths))
            drain.submit(lambda fetch=fetch, t0=t, n=n: deliver(fetch, t0, n))
            if progress:
                for _ in range(n):
                    progress()
            t += n
        for written in drain.drain():
            for f in written:
                f.result()
    finally:
        drain.close()
        rows.close()
        writers.shutdown(wait=True)


def _stack(arrays) -> np.ndarray:
    """A chunk's rows stacked into one array (span ``cli.stack``)."""
    with span("cli.stack"):
        return np.stack(arrays)


def _png_writer(palettes, save_dir):
    """emit for :func:`_run_group`: each mask straight to its palette PNG."""
    return lambda video, t, mask: save_prediction(mask, palettes[video], save_dir, f"{t:05d}", video)


def _frame(dataset, per_video, video, t_index, length):
    """A video's dataset item at ``t_index``, its last frame past its end."""
    return dataset[per_video[video][min(t_index, length - 1)]][0]


def inference_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch: int = 4,
                      strategy: str = "single", reduction: str = "mean",
                      progress: Optional[Callable[[], None]] = None, mesh=None) -> None:
    """``single``, ``hor-flip`` and ``vert-flip`` with ``video_batch`` videos
    (x the strategy's lanes) per lockstep group; with ``mesh`` the lanes
    spread over its data rows and the banks over each row's devices."""
    lane_spec = _STRATEGY_LANES[strategy]
    lanes = len(lane_spec)
    fusion = LaneFusion(tuple(s[2] for s in lane_spec), cfg.probability_propagation, reduction)
    per_video = _videos(dataset)

    def lane_frames(item):
        return [item if s[0] is None else item[s[0]] for s in lane_spec]

    def resolution(video):
        return tuple(lane_frames(dataset[per_video[video][0]][0])[0].shape[:2])

    n_chips = _mesh_data_chips(mesh)
    for hw, chunk, lengths in _groups(per_video, resolution, lambda hw: _clamp_video_batch(
            video_batch, lanes, hw, n_chips=n_chips, archs=(model.model,), dtype=compute_dtype(cfg, device))):
        labels, palettes, d_max = _first_labels(chunk, annotation_dir, save_dir)
        engine = _make_engine(model, hw, len(chunk) * lanes, _with_budget(cfg, d_max), device, fusion, mesh)
        state = None

        def row(t):
            return np.stack([lane for i, v in enumerate(chunk)
                             for lane in lane_frames(_frame(dataset, per_video, v, t, lengths[i]))])

        def start(first):
            nonlocal state
            lane_labels = [_flip_label(label, s[1]) for label in labels for s in lane_spec]
            state = engine.start_videos(first, np.stack(lane_labels))

        def step(batch, t, n):
            nonlocal state
            if lanes == 1:  # feature-resolution masks, upsampled on the host
                masks, state = engine.step_chunk_small(_stack(batch), state, t)
                return lambda: nearest_resize_host(masks[:n].cpu().numpy(), hw, hw_axes=(2, 3))
            masks, state = engine.step_chunk(_stack(batch), state, t)
            return lambda: masks[:n].cpu().numpy()

        _run_group(chunk, lengths, row, start, step, _png_writer(palettes, save_dir), progress)
        logger.info(f"batched group {chunk} ({strategy}) done.")


def inference_single_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch: int = 4,
                             progress: Optional[Callable[[], None]] = None) -> None:
    """The ``single`` strategy through :func:`inference_batched`."""
    inference_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch, "single", progress=progress)


def inference_multimodel_batched(dataset, annotation_dir, save_dir, model, additional_model, cfg, device,
                                 video_batch: int = 4, reduction: str = "mean",
                                 progress: Optional[Callable[[], None]] = None, mesh=None) -> None:
    """``multimodel`` in lockstep: each network keeps its own banks
    (reference ``inference_utils.py:411-511``) and the two are fused at
    feature resolution on the device, which is exact: with no flips both
    streams share the grid, so the nearest upsample commutes with the argmax
    and max (label mode) and with the reduction and float16 argmax
    (probability mode)."""
    per_video = _videos(dataset)
    probability = cfg.probability_propagation

    def fuse(s1, s2, hd, wd):  # (N, B, D, P) scores of both networks
        if probability:
            m = torch.argmax(REDUCTIONS[reduction](s1, s2).half(), dim=2)
        else:
            m = torch.maximum(torch.argmax(s1, dim=2), torch.argmax(s2, dim=2))
        return m.view(m.shape[0], m.shape[1], hd, wd).to(torch.uint8)

    def resolution(video):
        return tuple(dataset[per_video[video][0]][0].shape[:2])

    # two engines share the card: two lanes a video, under the wider network's envelope
    archs = (model.model, additional_model.model)
    n_chips = _mesh_data_chips(mesh)
    for hw, chunk, lengths in _groups(per_video, resolution, lambda hw: _clamp_video_batch(
            video_batch, 2, hw, n_chips=n_chips, archs=archs, dtype=compute_dtype(cfg, device))):
        labels, palettes, d_max = _first_labels(chunk, annotation_dir, save_dir)
        gcfg = _with_budget(cfg, d_max)
        e1 = _make_engine(model, hw, len(chunk), gcfg, device, mesh=mesh)
        e2 = _make_engine(additional_model, hw, len(chunk), gcfg, device, mesh=mesh)
        st1 = st2 = None

        def row(t):
            return np.stack([_frame(dataset, per_video, v, t, lengths[i]) for i, v in enumerate(chunk)])

        def start(first):
            nonlocal st1, st2
            st1 = e1.start_videos(first, np.stack(labels))
            st2 = e2.start_videos(first, np.stack(labels))

        def step(batch, t, n):
            nonlocal st1, st2
            frames = _stack(batch)
            s1, st1 = e1.step_chunk_scores(frames, st1, t)
            s2, st2 = e2.step_chunk_scores(frames, st2, t)
            masks = fuse(s1, s2, e1.hd, e1.wd)
            return lambda: nearest_resize_host(masks[:n].cpu().numpy(), hw, hw_axes=(2, 3))

        _run_group(chunk, lengths, row, start, step, _png_writer(palettes, save_dir), progress)
        logger.info(f"batched group {chunk} (multimodel) done.")


def inference_2_scale_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch: int = 4,
                              flip_pred: bool = False, reduction: str = "mean",
                              progress: Optional[Callable[[], None]] = None, mesh=None) -> None:
    """``2-scale`` / ``hor-2-scale`` (``flip_pred``) in lockstep: one engine
    per resolution (the second-scale stream has its own feature grid), each
    with its own banks. Label mode fuses on the host: each stream's argmax
    commutes with its nearest upsample, and the hor-2-scale unflip comes
    after the upsample, as in the reference (``inference_utils.py:386-396``).
    Probability mode fuses on the device one step at a time (upsample,
    unflip, reduction, float16 argmax)."""
    per_video = _videos(dataset)
    probability = cfg.probability_propagation

    def resolutions(video):
        item = dataset[per_video[video][0]][0]
        return tuple(item[0].shape[:2]), tuple(item[1].shape[:2])

    # two per-resolution engines share the card: two lanes a video
    n_chips = _mesh_data_chips(mesh)
    clamp = lambda hws: _clamp_video_batch(video_batch, 2, *hws, n_chips=n_chips, archs=(model.model,),
                                           dtype=compute_dtype(cfg, device))  # noqa: E731
    for (hw1, hw2), chunk, lengths in _groups(per_video, resolutions, clamp):
        labels, palettes, d_max = _first_labels(chunk, annotation_dir, save_dir)
        gcfg = _with_budget(cfg, d_max)
        b = len(chunk)
        e1 = _make_engine(model, hw1, b, gcfg, device, mesh=mesh)
        e2 = _make_engine(model, hw2, b, gcfg, device, mesh=mesh)
        st1 = st2 = None

        def fuse_prob(s1, s2):  # (N, B, D, P_i) → (N, B, H, W) uint8
            out = torch.empty((s1.shape[0], b) + hw1, dtype=torch.uint8, device=s1.device)
            for i in range(s1.shape[0]):
                x1 = nearest_resize(s1[i].transpose(1, 2).reshape(b, e1.hd, e1.wd, -1), hw1, hw_axes=(1, 2))
                x2 = nearest_resize(s2[i].transpose(1, 2).reshape(b, e2.hd, e2.wd, -1), hw1, hw_axes=(1, 2))
                if flip_pred:
                    x2 = torch.flip(x2, dims=(2,))
                out[i] = torch.argmax(REDUCTIONS[reduction](x1, x2).half(), dim=-1)
            return out

        def row(t):
            items = [_frame(dataset, per_video, v, t, lengths[i]) for i, v in enumerate(chunk)]
            return np.stack([it[0] for it in items]), np.stack([it[1] for it in items])

        def start(first):
            nonlocal st1, st2
            # stream 2 gets the full-resolution label (the reference's
            # ``get_labels``, ``predict.py:136-142``), mirrored for hor-2-scale
            st1 = e1.start_videos(first[0], np.stack(labels))
            st2 = e2.start_videos(first[1], np.stack([_flip_label(l, "h" if flip_pred else None) for l in labels]))

        def step(batch, t, n):
            nonlocal st1, st2
            x1, x2 = _stack([r[0] for r in batch]), _stack([r[1] for r in batch])
            if probability:
                s1, st1 = e1.step_chunk_scores(x1, st1, t)
                s2, st2 = e2.step_chunk_scores(x2, st2, t)
                fused = fuse_prob(s1[:n], s2[:n])
                return lambda: fused.cpu().numpy()
            m1, st1 = e1.step_chunk_small(x1, st1, t)
            m2, st2 = e2.step_chunk_small(x2, st2, t)

            def convert():
                a1 = nearest_resize_host(m1[:n].cpu().numpy(), hw1, hw_axes=(2, 3))
                a2 = nearest_resize_host(m2[:n].cpu().numpy(), hw1, hw_axes=(2, 3))
                return np.maximum(a1, a2[:, :, :, ::-1] if flip_pred else a2)

            return convert

        _run_group(chunk, lengths, row, start, step, _png_writer(palettes, save_dir), progress)
        logger.info(f"batched group {chunk} (2-scale) done.")


def inference_3_scale_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch: int = 4,
                              scale: float = 1.0, progress: Optional[Callable[[], None]] = None,
                              mesh=None) -> None:
    """``3-scale`` in lockstep: three passes at input scales [0.9, 1.0,
    ``scale``] (reference ``inference_utils.py:514-595``), each running
    ``video_batch`` videos per resolution group; each pass's masks are
    upsampled on the host to the reference's hard-coded (480, 910)
    (``:574``) and the passes fused by a per-pixel max."""
    out_hw = (480, 910)
    predictions: Dict[str, List[List[np.ndarray]]] = defaultdict(list)
    palettes: Dict[str, Optional[list]] = {}
    per_video = _videos(dataset)

    def scaled(frame, sc):
        """Nearest rescale of a uint8 frame on the host; it commutes with the
        normalisation the reference does first (``:526``)."""
        h, w = frame.shape[:2]
        hs, ws = int(np.ceil(h * sc)), int(np.ceil(w * sc))
        return frame[(np.arange(hs) * h) // hs][:, (np.arange(ws) * w) // ws]

    for pass_idx, sc in enumerate([0.9, 1.0, scale]):

        def resolution(video):
            h, w = dataset[per_video[video][0]][0].shape[:2]
            return int(np.ceil(h * sc)), int(np.ceil(w * sc))

        for hw, chunk, lengths in _groups(per_video, resolution, lambda hw: _clamp_video_batch(
                video_batch, 1, hw, n_chips=_mesh_data_chips(mesh), archs=(model.model,),
                dtype=compute_dtype(cfg, device))):
            labels, pals, d_max = _first_labels(chunk, annotation_dir, save_dir, copy=pass_idx == 0)
            palettes.update(pals)
            engine = _make_engine(model, hw, len(chunk), _with_budget(cfg, d_max), device, mesh=mesh)
            state = None

            def row(t):
                return np.stack([scaled(_frame(dataset, per_video, v, t, lengths[i]), sc)
                                 for i, v in enumerate(chunk)])

            def start(first):
                nonlocal state
                # first-frame labels go to this pass's scaled grid (``predict.py:146-153``)
                state = engine.start_videos(first, np.stack(labels))

            def step(batch, t, n):
                nonlocal state
                masks, state = engine.step_chunk_small(_stack(batch), state, t)
                return lambda: nearest_resize_host(masks[:n].cpu().numpy(), out_hw, hw_axes=(2, 3))

            # frame t of video v lands in collected[v][t - 1], in whatever order the writers run
            collected = {v: [None] * (lengths[i] - 1) for i, v in enumerate(chunk)}
            _run_group(chunk, lengths, row, start, step, lambda v, t, mask: collected[v].__setitem__(t - 1, mask),
                       progress)
            for v in chunk:
                predictions[v].append(collected[v])

    logger.info("Fusing 3-scale predictions.")
    for video, passes in predictions.items():
        fused = [np.maximum(np.maximum(a, b), c) for a, b, c in zip(*passes)]
        save_predictions(fused, palettes[video], save_dir, video)
