"""The comparisons that decide ``correct``.

Masks. For a sampled frame ``t`` of a finished video, the reference
propagates from its own float32 features of ``t`` and of the frames the
schedule samples, with the labels those frames were given: frame 0's
annotation, and for every later frame the mask the program delivered for
it (teacher forcing: the program's outputs are read only to be judged, as a
served model's tokens are). Every full-resolution pixel of the program's
mask at ``t`` is then judged by the reference's scores at the grid cell it
was upsampled from: ``gap`` is how far the score of the class the program
chose lies below the best one (0 where it chose the best). Three readings:
the widest gap, the share of pixels whose gap is above 0, and the mean gap
over all pixels judged.

The control takes the program's place: the same reference with every
activation rounded to float8 (e4m3), the precision below the bfloat16 that
the configuration states; the class it puts first is judged the same way.

Features. Frames whose encoder output the program holds in its memory
bank when the window closes are encoded again by the reference; the
reading is the worst frame's relative error, ‖program − reference‖ /
‖reference‖ over all its pixels and channels. The control's is that of the
float8 reference on the same frames.

Training. The losses of the first steps, and for every leaf the norm of
the first gradient as the optimizer takes it and the norm of the
parameters' change over the first steps, each taken as the gap between the
program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf; and the first gradient's
relative error over all leaves, which rounding moves where it moves no
norm.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vosbench.reference.propagation import downsample_labels, nearest_index, preimage_index, scores
from vosbench.reference.schedule import sample_frames
from vosbench.reference.layers import float32_exact, normalize


def encode(sd, network, cfg: dict, frames_u8: np.ndarray, device, round_to=None, batch: int = 4) -> torch.Tensor:
    """(N, H, W, 3) uint8 host frames → (N, P, C) float32 features, by the
    plain reference of the family module ``network``."""
    out = []
    with torch.no_grad(), float32_exact():
        for i in range(0, len(frames_u8), batch):
            x = normalize(torch.as_tensor(np.ascontiguousarray(frames_u8[i:i + batch]), device=device))
            f = network.forward(sd, cfg, x, round_to=round_to)
            out.append(f.permute(0, 2, 3, 1).reshape(f.shape[0], -1, f.shape[1]))
    return torch.cat(out)


def gap_map(ref_scores: torch.Tensor, classes_full: torch.Tensor, hw_small: Tuple[int, int]) -> torch.Tensor:
    """(D, P) reference scores and an (H, W) class map at full resolution →
    (H, W) gaps, each pixel judged at the grid cell it is read from."""
    hd, wd = hw_small
    h, w = classes_full.shape
    d = ref_scores.shape[0]
    dev = ref_scores.device
    rows = torch.as_tensor(nearest_index(h, hd), device=dev)
    cols = torch.as_tensor(nearest_index(w, wd), device=dev)
    src = (rows[:, None] * wd + cols[None, :]).reshape(-1)  # (H·W,)
    best = ref_scores.max(dim=0).values[src]
    cls = classes_full.reshape(-1).long()
    ok = cls < d
    chosen = ref_scores[cls.clamp(max=d - 1), src]
    return torch.where(ok, best - chosen, best).reshape(h, w)


class MaskJudge:
    """Judges sampled frames of finished videos; accumulates the readings."""

    def __init__(self, sd, cfg: dict, network, hw: Tuple[int, int], hw_small: Tuple[int, int], device,
                 control: bool = False):
        self.sd, self.cfg, self.network, self.hw, self.hw_small, self.device = sd, cfg, network, hw, hw_small, device
        self.control = control
        self.readings: Dict[str, List[float]] = {"gap": [], "miss": [], "pixels": []}
        self.control_readings: Dict[str, List[float]] = {"gap": [], "miss": [], "pixels": []}

    def _labels(self, r: int, label0: np.ndarray, masks: Dict[int, np.ndarray]) -> np.ndarray:
        hd, wd = self.hw_small
        if r == 0:
            return downsample_labels(label0, hd, wd)
        h, w = self.hw
        return masks[r][preimage_index(hd, h)][:, preimage_index(wd, w)]

    def judge_video(self, frames_u8: np.ndarray, label0: np.ndarray, masks: Dict[int, np.ndarray],
                    targets: Sequence[int]) -> None:
        """``masks``: frame index → the program's (H, W) mask, for frames 1
        .. L − 1; ``targets``: the frames to judge."""
        cfg = self.cfg
        plans = {t: sample_frames(t, cfg["frame_range"], cfg["ref_num"]) for t in targets}
        needed = sorted({t for t in targets} | {int(r) for idx, valid, _ in plans.values() for r in idx[valid]})
        pos = {f: i for i, f in enumerate(needed)}
        feats = encode(self.sd, self.network, cfg, frames_u8[needed], self.device)
        ctl = (encode(self.sd, self.network, cfg, frames_u8[needed], self.device, torch.float8_e4m3fn)
               if self.control else None)
        for t in targets:
            idx, valid, dense = plans[t]
            refs = [int(r) for r in idx[valid]]
            labels = torch.as_tensor(np.stack([self._labels(r, label0, masks) for r in refs]).astype(np.int64),
                                     device=self.device)
            sel = torch.as_tensor([pos[r] for r in refs], device=self.device)
            with torch.no_grad(), float32_exact():
                ref_s = scores(feats[sel], feats[pos[t]], labels, valid, dense, self.hw_small,
                               cfg["sigma_1"], cfg["sigma_2"], cfg["temperature"])
                gaps = gap_map(ref_s, torch.as_tensor(masks[t], device=self.device), self.hw_small)
                self._add(self.readings, gaps)
                if ctl is not None:
                    ctl_s = scores(ctl[sel], ctl[pos[t]], labels, valid, dense, self.hw_small,
                                   cfg["sigma_1"], cfg["sigma_2"], cfg["temperature"])
                    hd, wd = self.hw_small
                    small = ctl_s.argmax(dim=0).reshape(hd, wd)
                    rows = torch.as_tensor(nearest_index(self.hw[0], hd), device=self.device)
                    cols = torch.as_tensor(nearest_index(self.hw[1], wd), device=self.device)
                    self._add(self.control_readings, gap_map(ref_s, small[rows][:, cols], self.hw_small))

    def judge_features(self, frames_u8: np.ndarray, program_feats: torch.Tensor) -> None:
        """(N, H, W, 3) frames and the program's (N, P, C) features of them."""
        ref = encode(self.sd, self.network, self.cfg, frames_u8, self.device)
        self.readings["feat"] = [relative_error(program_feats, ref)]
        if self.control:
            ctl = encode(self.sd, self.network, self.cfg, frames_u8, self.device, torch.float8_e4m3fn)
            self.control_readings["feat"] = [relative_error(ctl, ref)]

    @staticmethod
    def _add(acc, gaps: torch.Tensor) -> None:
        acc["gap"].append(float(gaps.max()))
        acc["miss"].append(float((gaps > 0).sum()))
        acc.setdefault("gap_sum", []).append(float(gaps.double().sum()))
        acc["pixels"].append(float(gaps.numel()))

    @staticmethod
    def summary(acc) -> Dict[str, float]:
        out = {}
        if acc["pixels"]:
            n = sum(acc["pixels"])
            out.update(mask_gap=max(acc["gap"]), mask_miss=sum(acc["miss"]) / n, mask_gap_mean=sum(acc["gap_sum"]) / n)
        if acc.get("feat"):
            out["feat_err"] = max(acc["feat"])
        return out


def relative_error(program: torch.Tensor, reference: torch.Tensor) -> float:
    """Worst frame of ‖program − reference‖ / ‖reference‖, (N, ...) each."""
    p, r = program.double().flatten(1), reference.double().flatten(1)
    return float((torch.linalg.vector_norm(p - r, dim=1) / torch.linalg.vector_norm(r, dim=1)).max())


def norm_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keys: Optional[Sequence[str]] = None) -> Tuple[float, str]:
    """Worst leaf of |‖program‖ − ‖reference‖| / max(‖reference leaf‖,
    median leaf's), over ``keys`` (all of the reference's by default); →
    (reading, leaf)."""
    keys = list(reference) if keys is None else list(keys)
    ref_n = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in reference}
    median = float(np.median(list(ref_n.values())))
    worst, leaf = 0.0, ""
    for k in keys:
        p = float(torch.linalg.vector_norm(program[k].double())) if k in program else 0.0
        gap = abs(p - ref_n[k]) / max(ref_n[k], median, 1e-30)
        if gap > worst or not leaf:
            worst, leaf = gap, k
    return worst, leaf


def moving_leaves(raw_grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding: norm at
    least ``share`` of the median leaf's."""
    n = {k: float(torch.linalg.vector_norm(v.double())) for k, v in raw_grads.items()}
    median = float(np.median(list(n.values())))
    return [k for k, v in n.items() if v >= share * median]


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """Worst step of |program loss − reference loss| / |reference loss|."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))
