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

:func:`inference_batched` runs all seven strategies from their
descriptions (``strategies.py::strategy_passes``): videos are grouped by
their streams' resolutions and run in sorted chunks of ``video_batch``
videos, one engine per (network, resolution) whose lanes are the videos x
the streams that share it (hor-flip's two streams: one engine of two lanes
a video, one bank-kernel launch a step for all of them). A chunk is padded
to its longest video (shorter videos repeat their last frame and those
outputs are dropped) and the last device chunk to a whole chunk. Per-video
state never mixes and the frame schedule is shared, so each video's masks
are the single engine's. On the host, rows of B frames are decoded ahead on
a thread pool, and each chunk's PNGs are written on another while later
chunks run.

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
combine). ``_flip2d`` is ``strategies.flip_label``.
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
from semi_supervised_vos_tpu_torch.infer.strategies import (
    chunk_len,
    flip_label,
    frame_of,
    fuse,
    host_masks,
    run_strategy,
    stream_frame,
    stream_hw,
    with_budget,
)
from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
from semi_supervised_vos_tpu_torch.ops.onehot import index_to_onehot
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize
from semi_supervised_vos_tpu_torch.utils.image import (
    copy_first_annotation,
    first_annotation_path,
    load_annotation,
    save_prediction,
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
    only the saved output fuses the lanes, as ``strategies.py::fuse`` fuses
    streams.
    """

    pred_flips: Tuple[Optional[str], ...]  # per lane: None | 'h' | 'v'
    probability: bool = False
    reduction: str = "mean"

    @property
    def lanes(self) -> int:
        return len(self.pred_flips)


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
        """(B, D, P) scores → (lanes or videos, H, W) uint8 masks: each
        video's lanes fused as ``strategies.fuse`` fuses streams, upsampled
        on the device where it leaves them at feature resolution."""
        fusion = self.fusion or LaneFusion((None,))
        lanes = pred.view(1, self.b // fusion.lanes, fusion.lanes, *pred.shape[1:])
        masks = fuse([lanes[:, :, i] for i in range(fusion.lanes)], [(self.hd, self.wd)] * fusion.lanes,
                     fusion.pred_flips, (self.h, self.w), fusion.probability, fusion.reduction)[0]
        return masks if masks.shape[1:] == (self.h, self.w) else nearest_resize(masks, (self.h, self.w), (1, 2))

    @torch.no_grad()
    def start_videos(self, frames_u8: np.ndarray, labels_full: np.ndarray) -> BankState:
        """Frame 0 of every lane, (B, H, W, 3) frames and (B, H, W) labels: a
        fresh bank holding their features and downsampled one-hot labels."""
        with span("engine.start", new_id=True):
            state = self.init_state()
            label = self._upload_labels(labels_full)
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
#   * sam2_hiera_l (a 256-wide bank; Hiera's activations over the 2x
#     upsampled frame, 103,680 stage-1 tokens at 480p), the same probe
#     (``prof_torch/vit_lanes.py sam2_hiera_l``): 0.7618 GB a lane at 480p
#     and 3.805 GB at 1080p; 78 and 15 lanes (78 lanes peaked at 0.695 of
#     the card, ``tests/test_torch_cuda_hiera.py``).
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
                     "dino_vitb8": (82 * _HBM_ANCHOR_P_SMALL, 16 * _HBM_ANCHOR_P_LARGE),
                     "sam2_hiera_l": (78 * _HBM_ANCHOR_P_SMALL, 15 * _HBM_ANCHOR_P_LARGE)}
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


def _first_labels(chunk, annotation_dir, save_dir):
    """Each chunk video's first annotation: (labels, palettes, d_max); the
    annotation is copied into the output tree."""
    labels, palettes, d_max = [], {}, 0
    for v in chunk:
        ann = first_annotation_path(annotation_dir, v)
        label, d, palettes[v] = load_annotation(ann)
        d_max = max(d_max, d)
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


def _frame(dataset, per_video, video, t_index, length):
    """A video's dataset item at ``t_index``, its last frame past its end."""
    return dataset[per_video[video][min(t_index, length - 1)]][0]


def inference_batched(dataset, annotation_dir, save_dir, model, cfg, device, video_batch: int = 4,
                      strategy: str = "single", reduction: str = "mean",
                      progress: Optional[Callable[[], None]] = None, mesh=None, additional_model=None,
                      scale: float = 1.15) -> None:
    """Any of the seven strategies with ``video_batch`` videos per lockstep
    group, each group clamped to the card's lane envelope for its streams'
    resolutions and networks; with ``mesh`` the lanes spread over its data
    rows and the banks over each row's devices. One-stream groups fetch
    feature-resolution masks and upsample them on the drain worker; the
    others fuse every stream's scores on the device (``strategies.fuse``)."""
    networks = (model, additional_model)
    per_video = _videos(dataset)
    n_chips = _mesh_data_chips(mesh)
    dtype = compute_dtype(cfg, device)
    probability = cfg.probability_propagation

    def png(video, t, mask, palette):
        save_prediction(mask, palette, save_dir, f"{t:05d}", video)

    def run_pass(streams, sink=None, out_hw=None):
        def resolutions(video):
            hw = tuple(frame_of(dataset[per_video[video][0]][0]).shape[:2])
            return hw, tuple(stream_hw(s, hw) for s in streams)

        def clamp(key):  # every stream is a lane of every video on the card
            return _clamp_video_batch(video_batch, len(streams), *key[1], n_chips=n_chips,
                                      archs=tuple(networks[s.network].model for s in streams), dtype=dtype)

        for (hw, hws), chunk, lengths in _groups(per_video, resolutions, clamp):
            labels, palettes, d_max = _first_labels(chunk, annotation_dir, save_dir)
            gcfg, out, emit = with_budget(cfg, d_max), out_hw or hw, sink or png
            # one engine per (network, resolution), its lanes the streams sharing it, video-major; their
            # LaneFusion keeps a video's lanes on one data row of a mesh
            shared: Dict[tuple, List[int]] = defaultdict(list)
            for i, s in enumerate(streams):
                shared[(s.network, hws[i])].append(i)
            lanes = list(shared.values())
            engines = [_make_engine(networks[net], ehw, len(chunk) * len(idx), gcfg, device,
                                    LaneFusion(tuple(streams[i].pred_flip for i in idx), probability, reduction)
                                    if len(idx) > 1 else None, mesh)
                       for (net, ehw), idx in shared.items()]
            states = [None] * len(engines)

            def row(t):
                items = [_frame(dataset, per_video, v, t, lengths[i]) for i, v in enumerate(chunk)]
                return [np.stack([stream_frame(streams[i], it) for it in items for i in idx]) for idx in lanes]

            def start(first):
                for k, idx in enumerate(lanes):
                    states[k] = engines[k].start_videos(
                        first[k], np.stack([flip_label(label, streams[i].label_flip) for label in labels for i in idx]))

            def step(batch, t, n):
                frames = [_stack([r[k] for r in batch]) for k in range(len(engines))]
                if len(streams) == 1:
                    masks, states[0] = engines[0].step_chunk_small(frames[0], states[0], t)
                    masks = masks[:n]
                else:
                    scores, grids = [None] * len(streams), [None] * len(streams)
                    for k, idx in enumerate(lanes):
                        e = engines[k]
                        x, states[k] = e.step_chunk_scores(frames[k], states[k], t)
                        x = x[:n].unflatten(1, (len(chunk), len(idx)))
                        for lane, i in enumerate(idx):
                            scores[i], grids[i] = x[:, :, lane], (e.hd, e.wd)
                    masks = fuse(scores, grids, [s.pred_flip for s in streams], out, probability, reduction)
                return lambda: host_masks(masks, out)

            _run_group(chunk, lengths, row, start, step, lambda v, t, m: emit(v, t, m, palettes[v]), progress)
            logger.info(f"batched group {chunk} ({strategy}) done.")

    run_strategy(run_pass, strategy, scale, save_dir)
