"""Evaluation: pair GT and predicted PNGs, compute mean J & F (reference
``src/evaluation.py``): recursive sorted globs of both trees, per-frame
per-object J&F (object ids paired by zipping the sorted unique palette
values of each image, or by identical id with ``match_ids``), means over
objects then frames.
"""

from __future__ import annotations

import multiprocessing
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from semi_supervised_vos_tpu_torch.config import DEFAULT
from semi_supervised_vos_tpu_torch.eval.metrics import evaluate_segmentation
from semi_supervised_vos_tpu_torch.utils.logging import logger


def process_pair(gt, seg, match_ids: bool = False) -> np.ndarray:
    """Per-frame mean (J, F) over paired object ids."""
    gt_img = Image.open(gt).convert("P")
    seg_img = Image.open(seg).convert("P")
    seg_img = seg_img.resize(gt_img.size)
    gt_arr = np.asarray(gt_img)
    seg_arr = np.asarray(seg_img)
    gt_palette = np.unique(gt_arr)
    seg_palette = np.unique(seg_arr)
    if match_ids:
        pairs = [(c, c) for c in np.union1d(gt_palette, seg_palette)]
    else:
        pairs = list(zip(gt_palette, seg_palette))
    scores = [evaluate_segmentation(gt_arr == g, seg_arr == s) for g, s in pairs]
    return np.array(scores).mean(axis=0)


def evaluation_command_impl(
    ground_truth,
    computed_results,
    processes: Optional[int] = None,
    match_ids: bool = False,
) -> Tuple[float, float, float]:
    """Returns (j_mean, f_mean, j&f_mean) over all frame pairs."""
    ground_truth = sorted(Path(ground_truth).glob("**/*.png"))
    computed = sorted(Path(computed_results).glob("**/*.png"))
    if len(ground_truth) != len(computed):
        raise ValueError(f"count mismatch: {len(ground_truth)} GT vs {len(computed)} predictions")
    logger.info(f"Starting evaluation on {len(ground_truth)} pairs.")
    args = [(g, s, match_ids) for g, s in zip(ground_truth, computed)]
    processes = processes or DEFAULT.cpu_count
    if processes > 1:
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            scores = pool.starmap(process_pair, args)
    else:
        scores = [process_pair(*a) for a in args]
    scores = np.array(scores)
    j_mean = scores[:, 0].mean()
    f_mean = scores[:, 1].mean()
    jf_mean = np.array([j_mean, f_mean]).mean()
    logger.info(f"Evaluated: j_mean={j_mean}, f_mean={f_mean}, j&f_mean={jf_mean}.")
    return j_mean, f_mean, jf_mean
