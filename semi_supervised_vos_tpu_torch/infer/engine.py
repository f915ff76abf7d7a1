"""Per-video propagation engine with a fixed-capacity ring memory bank.

The reference grows ``feats_history`` / ``label_history`` with ``torch.cat``
every frame (``src/utils/inference_utils.py:23-87``). Here features and
labels live in a preallocated ring bank of capacity
``frame_range + continuous_frame + 1``; the sampling schedule never reaches
further back, so the ring is lossless. The bank is a pair of preallocated
tensors **updated in place**: each propagated frame overwrites its slot
``frame_idx % capacity`` (where the JAX engine donated the bank buffers to
its jitted step instead).

Per chunk of frames: one batched encode, then a sequential propagate →
write-back per frame: the argmax one-hot, or in probability mode the soft
scores themselves (reference ``src/utils/inference_utils.py:68``), with the
spatial prior off. The sampling schedule runs on the host with Python ints;
slots, validity and 1/σ² reach the affinity kernel through a small pinned
table copied without a host wait, so no frame waits on a device→host copy.
Masks (single stream) or raw scores (the multi-stream strategies) stay on
the device until the chunk is done.

Two paths, as in the JAX engine:
  * on CUDA: the BN-folded ``fast_encode`` with the fused bottleneck kernel,
    the bank-direct affinity kernel, bf16 labels;
  * on the CPU: the unfolded module forward, the dense golden
    ``affinity_propagate`` and float32 labels — the JAX engine's CPU path.

Features (the encoder's output and the bank) are in
``EngineConfig.compute_dtype`` (``SVOS_INFER_DTYPE`` at the CLI): bf16 or
float32, by default bf16 on the card and float32 on the CPU. On the card a
float32 engine folds a float32 table and runs the float32 variants of both
kernels; on the CPU bf16 rounds the features as the JAX CPU path does.
``SVOS_FAST_ENCODER=0`` makes the card encode with the module (full
float32, then rounded to the compute dtype) instead of ``fast_encode``; on
the CPU, which never takes the fast encoder, it changes nothing.

The engine sets no global state: its float32 convolutions on the card (the
encoder's stem, a whole float32 encode) run in a scope that restores both
of PyTorch's TF32 flags (``models/infer_fast.py``), so building or stepping
an engine leaves them as the caller set them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.config import DEFAULT
from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
from semi_supervised_vos_tpu_torch.core.sampling import bank_capacity, sample_frames
from semi_supervised_vos_tpu_torch.core.spatial import spatial_weight
from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
from semi_supervised_vos_tpu_torch.ops.onehot import index_to_onehot
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize

# ImageNet normalisation (reference ``src/utils/datasets.py:36-39``).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def grouped_map(fn, x, cap: int) -> torch.Tensor:
    """``fn`` over leading-axis groups of at most ``cap`` rows of ``x``,
    concatenated (a remainder group last): keeps an encode batch at its
    memory cap whatever the chunk length."""
    n = x.shape[0]
    g = max(1, min(cap, n))
    if g >= n:
        return fn(x)
    out = None
    for i in range(0, n, g):
        y = fn(x[i : i + g])
        if out is None:
            out = y.new_empty((n,) + tuple(y.shape[1:]))
        out[i : i + y.shape[0]] = y
    return out


class BankState(NamedTuple):
    """Ring memory bank: features (cap, P, C) and labels (cap, P, D)."""

    feats: torch.Tensor
    labels: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    ref_num: int = 9
    frame_range: int = 40
    temperature: float = 1.0
    sigma_1: float = 8.0
    sigma_2: float = 21.0
    probability_propagation: bool = False
    num_classes: int = DEFAULT.num_classes
    feature_dim: int = 256
    continuous_frame: int = DEFAULT.continuous_frame
    # features' dtype: torch.bfloat16 or torch.float32; None is the device's
    # default (:func:`compute_dtype`)
    compute_dtype: Optional[torch.dtype] = None

    @property
    def capacity(self) -> int:
        return bank_capacity(self.frame_range, self.continuous_frame)


def compute_dtype(cfg: EngineConfig, device) -> torch.dtype:
    """The features' dtype of an engine on ``device``: ``cfg.compute_dtype``,
    else bf16 on the card and float32 on the CPU (the JAX CLI's defaults)."""
    if cfg.compute_dtype is not None:
        return cfg.compute_dtype
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


class PropagationEngine:
    """Drives one video stream at one (H, W) resolution."""

    def __init__(self, model, frame_hw: Tuple[int, int], cfg: EngineConfig, device, table=None):
        self.device = torch.device(device)
        # engines of one mesh share one folded table per card (``table``,
        # already on ``device``); the model then stays where it is
        self.model = (model if table is not None else model.to(self.device)).eval()
        self.cfg = cfg
        self.h, self.w = frame_hw
        self.hd, self.wd = out_spatial(self.h, self.w)
        self.p = self.hd * self.wd
        self.on_card = self.device.type == "cuda"
        self.mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self.std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self.dtype = compute_dtype(cfg, self.device)
        if self.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be torch.bfloat16 or torch.float32, got {self.dtype}")
        # the folded table of fast_encode (None: the module encodes)
        self.table = None
        if self.on_card:
            from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet

            self.label_dtype = torch.bfloat16
            self.d_pad = -(-cfg.num_classes // 8) * 8
            if table is None and os.environ.get("SVOS_FAST_ENCODER", "1") != "0":
                with torch.no_grad():
                    table = fold_vosnet(self.model, self.dtype)
            self.table = table
        else:
            self.label_dtype = torch.float32
            self.d_pad = cfg.num_classes
            self._wd, self._ws = self._prior_matrices()

    def _prior_matrices(self):
        """The CPU path's dense (P, P) Gaussian priors, dense and sparse;
        none in probability mode, which has no spatial prior."""
        if self.cfg.probability_propagation:
            return None, None
        hw = (self.hd, self.wd)
        return (spatial_weight(hw, self.cfg.sigma_1, device=self.device),
                spatial_weight(hw, self.cfg.sigma_2, device=self.device))

    @torch.no_grad()
    def encode(self, frames_u8) -> torch.Tensor:
        """(N, H, W, 3) uint8 frames, a numpy array or a tensor (one already
        on the engine's device is read in place) → (N, P, C) features in
        the engine dtype."""
        if isinstance(frames_u8, torch.Tensor):
            if frames_u8.dtype != torch.uint8:
                raise TypeError(f"frames must be uint8, got {frames_u8.dtype}")
            x = frames_u8.to(self.device)
        else:
            # decoded frames are read-only arrays; torch wants writable memory
            x = torch.from_numpy(np.require(frames_u8, np.uint8, ['C', 'W'])).to(self.device)
        x = (x.float() / 255.0 - self.mean) / self.std
        if self.table is not None:
            from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode

            feats = fast_encode(self.table, x, self.dtype, arch=self.model.model)
        elif self.on_card:
            from semi_supervised_vos_tpu_torch.models.infer_fast import _full_float32

            # SVOS_FAST_ENCODER=0: the module in full float32 (engines of a
            # mesh share the module: it follows the encoding card)
            if next(self.model.parameters()).device != self.device:
                self.model.to(self.device)
            with _full_float32():
                feats = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            feats = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return feats.reshape(x.shape[0], self.p, self.cfg.feature_dim).to(self.dtype)

    def _propagate(self, target: torch.Tensor, state: BankState, frame_idx: int) -> torch.Tensor:
        """(P, C) target → (num_classes, P) float32 scores from the bank."""
        cfg = self.cfg
        idx, valid, dense = sample_frames(frame_idx, cfg.frame_range, cfg.ref_num, cfg.continuous_frame)
        slots = idx % cfg.capacity
        if self.on_card:
            from semi_supervised_vos_tpu_torch.ops.affinity import affinity_from_bank

            pred = affinity_from_bank(
                state.feats, state.labels, target.float(), slots,
                feature_hw=(self.hd, self.wd), temperature=cfg.temperature,
                valid=valid, dense=dense, sigma_1=cfg.sigma_1, sigma_2=cfg.sigma_2,
                spatial=not cfg.probability_propagation,
            )
            return pred[: cfg.num_classes]
        sel = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        return affinity_propagate(
            state.feats[sel], target, state.labels[sel],
            temperature=cfg.temperature,
            valid=torch.as_tensor(valid, device=self.device),
            dense=torch.as_tensor(dense, device=self.device),
            weight_dense=self._wd, weight_sparse=self._ws,
        )

    def _write(self, state: BankState, slot: int, feats: torch.Tensor, labels: torch.Tensor) -> None:
        """Overwrite one whole bank slot in place with (P, C) features and
        (P, D_pad) labels (cast to the bank's types)."""
        state.feats[slot].copy_(feats)
        state.labels[slot].copy_(labels)

    def _step(self, target: torch.Tensor, state: BankState, frame_idx: int) -> torch.Tensor:
        """Propagate one encoded (P, C) frame and write it into its slot: the
        soft scores in probability mode, else the argmax one-hot. Returns the
        (num_classes, P) float32 scores. (The lockstep engine passes (B, P, C)
        lanes and gets (B, num_classes, P).)"""
        pred = self._propagate(target, state, frame_idx)
        if self.cfg.probability_propagation:
            labels = torch.nn.functional.pad(pred.transpose(-1, -2), (0, self.d_pad - pred.shape[-2]))
        else:
            labels = index_to_onehot(torch.argmax(pred, dim=-2), self.d_pad, self.label_dtype)
        self._write(state, frame_idx % self.cfg.capacity, target, labels)
        return pred

    def init_state(self) -> BankState:
        cfg = self.cfg
        return BankState(
            feats=torch.zeros((cfg.capacity, self.p, cfg.feature_dim), dtype=self.dtype, device=self.device),
            labels=torch.zeros((cfg.capacity, self.p, self.d_pad), dtype=self.label_dtype, device=self.device),
        )

    @torch.no_grad()
    def start_video(self, frame_u8: np.ndarray, label_full: np.ndarray) -> BankState:
        """Frame 0: a fresh bank holding its features and the downsampled
        annotation."""
        state = self.init_state()
        feats = self.encode(frame_u8[None])[0]
        label = torch.as_tensor(np.asarray(label_full, np.int64), device=self.device)
        label_small = nearest_resize(label[:, :, None], (self.hd, self.wd)).reshape(self.p)
        self._write(state, 0, feats, index_to_onehot(label_small, self.d_pad, self.label_dtype))
        return state

    def _encode_chunk(self, frames_u8) -> torch.Tensor:
        """A chunk's frames, encoded in one batch."""
        return self.encode(frames_u8)

    @torch.no_grad()
    def step_chunk_small(self, frames_u8: np.ndarray, state: BankState, start_idx: int):
        """Frames ``start_idx .. start_idx + N - 1``: one batched encode, then
        sequential propagation with in-place bank writes. Returns
        ((N, hd, wd) uint8 feature-resolution masks on the device, state)."""
        feats = self._encode_chunk(frames_u8)
        masks = torch.empty(feats.shape[:-2] + (self.hd, self.wd), dtype=torch.uint8, device=self.device)
        for i in range(feats.shape[0]):
            masks[i] = torch.argmax(self._step(feats[i], state, start_idx + i), dim=-2).view(masks.shape[1:])
        return masks, state

    @torch.no_grad()
    def step_chunk_scores(self, frames_u8: np.ndarray, state: BankState, start_idx: int):
        """Like :meth:`step_chunk_small`, but returns the raw feature-resolution
        scores ((N, num_classes, P) float32 on the device, state): the
        multi-stream strategies fuse them across streams."""
        feats = self._encode_chunk(frames_u8)
        scores = [self._step(feats[i], state, start_idx + i) for i in range(feats.shape[0])]
        return torch.stack(scores), state
