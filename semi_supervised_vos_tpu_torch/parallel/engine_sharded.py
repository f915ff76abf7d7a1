"""Propagation with the memory bank's pixel rows sharded over devices: the
PyTorch counterpart of ``semi_supervised_vos_tpu/parallel/engine_sharded.py``.

One video stream's ring bank spans the devices of the mesh's ``model`` axis
(for long videos, large frames, or banks bigger than one card):

  * shard s holds the global pixel rows [s·P_loc, (s + 1)·P_loc) of every
    slot, P_loc = ceil(P / n): (capacity, P_loc, C) features and
    (capacity, P_loc, D_pad) labels on its device, bf16 on the card and
    float32 on the CPU, as the single engine's bank. The last shard's rows
    past P stay zero and are masked by their global index;
  * each frame is encoded once, on the axis's first device (the JAX engine
    replicates the encode; one encode gives the same features), and every
    shard stores its own row block of it, so bank writes stay local apart
    from the copy of the frame's rows;
  * each shard runs the bank kernel in stats mode on its row block
    (``ops/affinity.py::affinity_from_bank_batched(..., row_base=s·P_loc,
    return_stats=True)``), and ``sharded_affinity.distributed_softmax_combine``
    combines the shards' (m, l, acc) on the first device with the combine
    kernel. On CPU tensors both run their plain versions (the same
    statistics: rows masked and the prior built from global pixel indices,
    no (P, P) matrix), so the CPU runs the card's code path.

The JAX engine pads P_loc to its kernel's ``block_r`` (TPU tiling); the
Hopper kernel masks rows past its bank's P_loc and past the global P
itself, so nothing is padded here.

:class:`BankShards` holds that logic for any leading lane shape: the
single-stream :class:`ShardedPropagationEngine` here, and the bank-sharded
lockstep engine of the 2-D mesh (``parallel/batched_dp.py``), through
:class:`BankShardedEngineMixin`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
from semi_supervised_vos_tpu_torch.infer.engine import BankState, EngineConfig, PropagationEngine
from semi_supervised_vos_tpu_torch.ops.affinity import affinity_from_bank_batched
from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh
from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine


class BankShards:
    """Ring banks whose pixel rows are sharded over ``devices``, for lanes of
    any leading shape (``()`` for one stream, ``(B,)`` for lockstep lanes).
    A state is a :class:`BankState` of per-shard tuples: features
    (capacity, *lanes, P_loc, C) and labels (capacity, *lanes, P_loc,
    D_pad)."""

    def __init__(self, devices: Sequence[torch.device], feature_hw: Tuple[int, int], cfg: EngineConfig,
                 dtype, label_dtype, d_pad: int):
        self.devices = [torch.device(d) for d in devices]
        self.hd, self.wd = feature_hw
        self.p = self.hd * self.wd
        self.p_loc = -(-self.p // len(self.devices))
        self.cfg = cfg
        self.dtype, self.label_dtype, self.d_pad = dtype, label_dtype, d_pad

    def _real_rows(self, s: int) -> int:
        """Rows of shard s below P (the rest of its block is padding)."""
        return max(0, min(self.p_loc, self.p - s * self.p_loc))

    def init_state(self, lanes: Tuple[int, ...]) -> BankState:
        cap, c = self.cfg.capacity, self.cfg.feature_dim
        return BankState(
            feats=tuple(torch.zeros((cap, *lanes, self.p_loc, c), dtype=self.dtype, device=d) for d in self.devices),
            labels=tuple(torch.zeros((cap, *lanes, self.p_loc, self.d_pad), dtype=self.label_dtype, device=d)
                         for d in self.devices),
        )

    def local_rows(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """Shard s's real rows of a (..., P, ·) tensor (JAX ``_local_rows``;
        the padding rows past P are never written, so they stay zero)."""
        r0 = s * self.p_loc
        return x[..., r0 : r0 + self._real_rows(s), :]

    def write(self, state: BankState, slot: int, feats: torch.Tensor, labels: torch.Tensor) -> None:
        """Overwrite bank slot ``slot`` in place: each shard stores its row
        block of the (*lanes, P, C) features and (*lanes, P, D_pad) labels."""
        for s in range(len(self.devices)):
            n = self._real_rows(s)
            if n:
                state.feats[s][slot][..., :n, :].copy_(self.local_rows(feats, s))
                state.labels[s][slot][..., :n, :].copy_(self.local_rows(labels, s))

    def propagate(self, targets: torch.Tensor, state: BankState, frame_idx: int) -> torch.Tensor:
        """(*lanes, P, C) targets on the first device → (*lanes, num_classes,
        P) float32 scores there: one stats-mode bank-kernel launch per shard
        for all lanes, then the combine."""
        cfg = self.cfg
        idx, valid, dense = sample_frames(frame_idx, cfg.frame_range, cfg.ref_num, cfg.continuous_frame)
        slots = idx % cfg.capacity
        lanes = tuple(targets.shape[:-2])
        tgt = targets.reshape(-1, self.p, targets.shape[-1])
        b = tgt.shape[0]

        def lane_view(t):  # (capacity, *lanes, P_loc, ·) → (capacity, B, P_loc, ·)
            return t.view(t.shape[0], b, self.p_loc, t.shape[-1])

        stats = [
            affinity_from_bank_batched(
                lane_view(f), lane_view(lab), tgt.to(dev), slots,
                feature_hw=(self.hd, self.wd), temperature=cfg.temperature, valid=valid, dense=dense,
                sigma_1=cfg.sigma_1, sigma_2=cfg.sigma_2, spatial=not cfg.probability_propagation,
                row_base=s * self.p_loc, return_stats=True,
            )
            for s, (dev, f, lab) in enumerate(zip(self.devices, state.feats, state.labels))
        ]
        pred = distributed_softmax_combine(*zip(*stats))
        return pred[:, : cfg.num_classes].reshape(lanes + (cfg.num_classes, self.p))


class BankShardedEngineMixin:
    """An engine's bank hooks over :class:`BankShards` (``self.shards``, set
    by the subclass): writes, propagation, and no dense (P, P) priors. A
    subclass lists it before the engine class and defines ``init_state``."""

    def _prior_matrices(self):
        # the prior's rows are built per shard from global pixel indices
        return None, None

    def _write(self, state: BankState, slot: int, feats: torch.Tensor, labels: torch.Tensor) -> None:
        self.shards.write(state, slot, feats, labels)

    def _propagate(self, target: torch.Tensor, state: BankState, frame_idx: int) -> torch.Tensor:
        return self.shards.propagate(target, state, frame_idx)


class ShardedPropagationEngine(BankShardedEngineMixin, PropagationEngine):
    """One video stream whose ring bank spans the devices of the mesh's
    ``model`` axis (data row 0). The surface of ``PropagationEngine`` —
    ``init_state``, ``start_video``, ``step_chunk_small``,
    ``step_chunk_scores`` — plus the per-frame :meth:`step`; the multi-stream
    strategies fuse its scores as any engine's."""

    def __init__(self, model, frame_hw: Tuple[int, int], cfg: EngineConfig, mesh: Mesh):
        devices = mesh.devices[0]
        super().__init__(model, frame_hw, cfg, devices[0])
        self.shards = BankShards(devices, (self.hd, self.wd), cfg, self.dtype, self.label_dtype, self.d_pad)
        self.p_loc = self.shards.p_loc

    def init_state(self) -> BankState:
        return self.shards.init_state(())

    @torch.no_grad()
    def step(self, frame_u8: np.ndarray, state: BankState, frame_idx: int):
        """One (H, W, 3) frame → ((num_classes, P) float32 scores, state)."""
        return self._step(self.encode(frame_u8[None])[0], state, frame_idx), state
