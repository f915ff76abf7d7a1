"""Lockstep inference over a mesh: video lanes over the ``data`` rows and,
with a ``model`` axis > 1, every bank's pixel rows over each row's devices.
The PyTorch counterpart of ``semi_supervised_vos_tpu/parallel/batched_dp.py``.

Lanes are independent, so the data axis needs no collective: data row r runs
its own lockstep engine (``infer/batched.py::BatchedPropagationEngine``) on
its block of lanes, encoding on the row's first device. With ``model`` > 1
that engine is :class:`BankShardedBatchedEngine`, whose banks shard their
pixel rows over the row's devices and whose steps combine the shards'
softmax statistics (``parallel/engine_sharded.py::BankShards``): the 2-D
inference mesh, data parallelism for throughput times bank sharding for
banks bigger than one card.

The lane axis is video-major, and the batch is padded to a whole number of
videos per row by replaying the last video's lanes; their outputs are
dropped. A video's lanes therefore never straddle two rows, and the fusion
of a multi-stream strategy stays inside one engine. The public surface
(``init_state``, ``start_videos``, ``step``, ``step_chunk``,
``step_chunk_small``, ``step_chunk_scores``, ``h``, ``w``, ``hd``, ``wd``)
is the one-card engine's, with its global, unpadded shapes; outputs are
gathered on the first row's first device. A state is the list of the rows'
states.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine, LaneFusion
from semi_supervised_vos_tpu_torch.infer.engine import BankState
from semi_supervised_vos_tpu_torch.parallel.engine_sharded import BankShardedEngineMixin, BankShards
from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh, replicate
from semi_supervised_vos_tpu_torch.utils.logging import logger


class BankShardedBatchedEngine(BankShardedEngineMixin, BatchedPropagationEngine):
    """The lockstep engine with every lane's bank rows sharded over
    ``devices`` (JAX ``bank_axis``); it encodes on ``devices[0]``."""

    def __init__(self, model, frame_hw: Tuple[int, int], batch: int, cfg, devices: Sequence[torch.device],
                 fusion: Optional[LaneFusion] = None, table=None):
        super().__init__(model, frame_hw, batch, cfg, devices[0], fusion, table)
        self.shards = BankShards(devices, (self.hd, self.wd), cfg, self.dtype, self.label_dtype, self.d_pad)

    def init_state(self) -> BankState:
        return self.shards.init_state((self.b,))


class DataParallelBatchedEngine:
    """B lockstep lanes over the mesh's data rows; with a model axis > 1 each
    row's banks also shard their pixel rows over the row's devices."""

    def __init__(self, model, frame_hw: Tuple[int, int], batch: int, cfg, mesh: Mesh,
                 fusion: Optional[LaneFusion] = None):
        n, n_bank = mesh.shape["data"], mesh.shape["model"]
        lanes = fusion.lanes if fusion is not None else 1
        if batch % lanes:
            raise ValueError(f"batch {batch} is not a multiple of the {lanes} lanes a video takes")
        self.lanes = lanes
        self.b = batch
        self.videos = batch // lanes
        self.v_pad = -(-self.videos // n) * n
        self.b_pad = self.v_pad * lanes
        self.per_row = self.b_pad // n
        if self.v_pad > self.videos:
            logger.info(
                f"data-parallel lockstep: {self.videos} video(s) over {n} row(s) pads to {self.v_pad}: "
                f"{self.v_pad - self.videos} duplicated full-video inference(s) per group (results are discarded)."
            )
        self.engines: List[BatchedPropagationEngine] = []
        tables = None
        for row in mesh.devices:
            table = tables[row[0]] if tables is not None else None
            if n_bank > 1:
                engine = BankShardedBatchedEngine(model, frame_hw, self.per_row, cfg, row, fusion, table)
            else:
                engine = BatchedPropagationEngine(model, frame_hw, self.per_row, cfg, row[0], fusion, table)
            if tables is None and engine.on_card:
                # one folded encoder table per card that encodes
                tables = replicate(Mesh([[r[0]] for r in mesh.devices]), engine.table)
            self.engines.append(engine)
        inner = self.engines[0]
        self.cfg = inner.cfg
        self.device = inner.device
        self.h, self.w, self.hd, self.wd, self.p = inner.h, inner.w, inner.hd, inner.wd, inner.p
        # fused multi-lane engines return one row per video, the others one per lane
        self._video_rows = fusion is not None and lanes > 1

    def _pad(self, x, axis: int) -> np.ndarray:
        """Pad the lane axis to ``b_pad`` by replaying the last video's lanes."""
        x = np.asarray(x)
        if self.b_pad == self.b:
            return x
        last = np.take(x, np.arange(x.shape[axis] - self.lanes, x.shape[axis]), axis=axis)
        reps = [1] * x.ndim
        reps[axis] = self.v_pad - self.videos
        return np.concatenate([x, np.tile(last, reps)], axis=axis)

    def _rows(self, x, axis: int):
        """Each data row's block of the padded lane axis."""
        x = self._pad(x, axis)
        return [np.take(x, np.arange(r * self.per_row, (r + 1) * self.per_row), axis=axis)
                for r in range(len(self.engines))]

    def _gather(self, outs, axis: int, video_rows: bool) -> torch.Tensor:
        """The rows' outputs concatenated on the first device, padding dropped."""
        k = self.videos if video_rows else self.b
        out = torch.cat([o.to(self.device) for o in outs], dim=axis)
        return out.narrow(axis, 0, k)

    def init_state(self) -> list:
        return [e.init_state() for e in self.engines]

    def start_videos(self, frames_u8, labels_full) -> list:
        return [e.start_videos(f, lab) for e, f, lab in zip(self.engines, self._rows(frames_u8, 0),
                                                          self._rows(labels_full, 0))]

    def step(self, frames_u8, state: list, frame_idx: int):
        outs = [e.step(f, st, frame_idx)[0] for e, f, st in zip(self.engines, self._rows(frames_u8, 0), state)]
        return self._gather(outs, 0, self._video_rows), state

    def step_chunk(self, frames_u8, state: list, start_idx: int):
        outs = [e.step_chunk(f, st, start_idx)[0]
                for e, f, st in zip(self.engines, self._rows(frames_u8, 1), state)]
        return self._gather(outs, 1, self._video_rows), state

    def step_chunk_small(self, frames_u8, state: list, start_idx: int):
        outs = [e.step_chunk_small(f, st, start_idx)[0]
                for e, f, st in zip(self.engines, self._rows(frames_u8, 1), state)]
        return self._gather(outs, 1, False), state

    def step_chunk_scores(self, frames_u8, state: list, start_idx: int):
        outs = [e.step_chunk_scores(f, st, start_idx)[0]
                for e, f, st in zip(self.engines, self._rows(frames_u8, 1), state)]
        return self._gather(outs, 1, False), state
