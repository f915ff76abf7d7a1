"""The memory-bank sampling schedule and the Gaussian spatial prior, as the
published method states them (Zhang et al., arXiv:2004.07193, and its
reference code ``src/model/predict.py:74-89`` and ``:158-175``).

* while ``t <= ref_num`` every earlier frame is a reference;
* afterwards ``ref_num - 3`` frames are spaced evenly over the ``frame_range``
  frames before the last three, truncated to integers (``np.linspace`` then
  ``astype(int)``), and the three frames just before ``t`` follow;
* a slot's prior is ``exp(-d² / σ²)`` over pixel coordinates
  ``(index / wd, index % wd)`` (the row fractional, as the reference has it),
  σ₁ = 8 for the last four references once ``t > 15`` (every reference
  before), σ₂ = 21 for the others.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CONTINUOUS_FRAME = 4
DENSE_SWITCH_FRAME = 15


def sample_frames(t: int, frame_range: int, ref_num: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx, valid, dense), each (ref_num,): the logical frame of each slot
    (0 where invalid), whether it takes part, whether it takes σ₁."""
    dense_num = CONTINUOUS_FRAME - 1
    slot = np.arange(ref_num)
    if t <= ref_num:
        valid = slot < t
        idx = np.where(valid, slot, 0)
        n_valid = min(t, ref_num)
    else:
        ref_end = t - dense_num - 1
        ref_start = max(ref_end - frame_range, 0)
        sparse = np.linspace(ref_start, ref_end, ref_num - dense_num).astype(np.int64)
        idx = np.concatenate([sparse, t - dense_num + np.arange(dense_num)])
        valid = np.ones(ref_num, bool)
        n_valid = ref_num
    dense = slot >= n_valid - CONTINUOUS_FRAME if t > DENSE_SWITCH_FRAME else np.ones(ref_num, bool)
    return idx.astype(np.int64), valid, dense


def slot_inv_sigma2(valid, dense, sigma_1: float, sigma_2: float) -> np.ndarray:
    """Each slot's 1/σ², float32 (the kernel's launch argument type)."""
    return np.where(np.asarray(dense), 1.0 / sigma_1 ** 2, 1.0 / sigma_2 ** 2).astype(np.float32)


def bank_capacity(frame_range: int) -> int:
    """Ring slots the schedule reaches back over, plus the frame written."""
    return frame_range + CONTINUOUS_FRAME + 1
