"""Memory-bank frame sampling schedule (reference
``src/model/predict.py:74-89``).

* while ``frame_idx <= num_refs`` every previous frame is a reference;
* afterwards ``num_refs - (continuous_frame - 1)`` frames are linspaced over
  the trailing ``take_range`` window and the ``continuous_frame - 1``
  immediately-previous frames are appended.

The schedule runs on the host with Python ints: the engine hands the slots,
their validity and their 1/σ² to the affinity kernel as launch arguments, so
no frame needs a device→host sync. :func:`sample_frames` keeps the JAX
package's fixed-shape form (``num_refs`` slots plus validity and dense
masks) so both engines see the same slot table.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from semi_supervised_vos_tpu_torch.config import DEFAULT


def sample_frames_host(
    frame_idx: int,
    take_range: int,
    num_refs: int,
    continuous_frame: int = DEFAULT.continuous_frame,
) -> List[int]:
    """Direct transcription of the reference schedule (``np.linspace`` +
    truncation): the variable-length list of reference frames."""
    if frame_idx <= num_refs:
        return list(range(frame_idx))
    dense_num = continuous_frame - 1
    sparse_num = num_refs - dense_num
    ref_end = frame_idx - dense_num - 1
    ref_start = max(ref_end - take_range, 0)
    idx = np.linspace(ref_start, ref_end, sparse_num).astype(np.int64).tolist()
    for j in range(dense_num):
        idx.append(frame_idx - dense_num + j)
    return idx


def sample_frames(
    frame_idx: int,
    take_range: int,
    num_refs: int,
    continuous_frame: int = DEFAULT.continuous_frame,
    dense_switch_frame: int = DEFAULT.dense_switch_frame,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-shape schedule: (idx, valid, dense), each (num_refs,).

    ``idx`` holds logical frame indices (invalid slots hold 0), ``valid``
    marks the slots that take part in the softmax, ``dense`` the slots that
    use the dense (sigma_1) prior: the last ``continuous_frame`` valid slots
    once ``frame_idx > dense_switch_frame``, otherwise every slot. The
    linspace truncation uses exact integer arithmetic
    (``start + (span * i) // (n - 1)``), equal to ``np.linspace`` +
    ``astype(int)`` for non-negative spans.
    """
    frame_idx = int(frame_idx)
    dense_num = continuous_frame - 1
    sparse_num = num_refs - dense_num
    slot = np.arange(num_refs, dtype=np.int32)
    if frame_idx <= num_refs:
        valid = slot < frame_idx
        idx = np.where(valid, slot, 0).astype(np.int32)
        n_valid = min(frame_idx, num_refs)
    else:
        ref_end = frame_idx - dense_num - 1
        ref_start = max(ref_end - take_range, 0)
        span = ref_end - ref_start
        if sparse_num > 1:
            lin = ref_start + (span * slot) // (sparse_num - 1)
        else:
            lin = ref_start + slot * 0
        tail = frame_idx - dense_num + (slot - sparse_num)
        idx = np.where(slot < sparse_num, lin, tail).astype(np.int32)
        valid = np.ones(num_refs, bool)
        n_valid = num_refs
    if frame_idx > dense_switch_frame:
        dense = slot >= n_valid - continuous_frame
    else:
        dense = np.ones(num_refs, bool)
    return idx, valid, dense


def bank_capacity(take_range: int, continuous_frame: int = DEFAULT.continuous_frame) -> int:
    """Minimum ring capacity so every sampled logical index is live: the
    oldest index sampled at frame ``t`` is at most
    ``take_range + continuous_frame`` behind ``t``; one extra slot holds the
    frame being written."""
    return take_range + continuous_frame + 1
