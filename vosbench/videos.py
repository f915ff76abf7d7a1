"""The one generator of traffic: clips made on the device from the seed,
in a few large calls per clip set, then handed over as host arrays (the
decoded frames a data loader would hold) or left on the card (a staged
training batch).

A clip is a blocky textured background (8 x 8 blocks, as a frame's
stride-8 grid sees them), light noise on every frame, and ``objects``
rectangles of fixed sizes, each a flat colour over a faint copy of the
background, that move at a fixed speed and bounce off the borders, each
with its own class (1, 2, ...; later objects in front). The labels are
those classes per pixel.

Every seed draws the same set of sizes in another order: video lengths are
spaced evenly over the traffic's ``lengths`` range and only their order
and the clips' content come from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from vosbench.reference.train import palette


# objects' (height, width) as shares of the frame's, and their speed in
# shares of the frame a frame
SIZES = ((0.30, 0.25), (0.18, 0.22), (0.24, 0.14))
SPEED = 0.008


@dataclass
class Video:
    frames: np.ndarray  # (L, H, W, 3) uint8, host
    label0: np.ndarray  # (H, W) int64 classes of frame 0

    @property
    def length(self) -> int:
        return self.frames.shape[0]


def _reflect(pos: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Positions bounced between 0 and ``hi``."""
    period = 2 * hi.clamp(min=1)
    m = torch.remainder(pos, period)
    return torch.where(m > hi, period - m, m)


def make_clips(g: torch.Generator, n: int, t: int, h: int, w: int, objects: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` clips of ``t`` frames: ((n, t, h, w, 3) uint8 frames, (n, t, h,
    w) uint8 classes), on ``device``."""
    bh, bw = -(-h // 8), -(-w // 8)
    bg = torch.randint(0, 200, (n, 1, bh, bw, 3), generator=g, device=device, dtype=torch.uint8)
    frames = bg.repeat_interleave(8, 2).repeat_interleave(8, 3)[:, :, :h, :w].expand(n, t, h, w, 3).clone()
    frames += torch.randint(0, 24, (n, t, h, w, 3), generator=g, device=device, dtype=torch.uint8)
    labels = torch.zeros((n, t, h, w), dtype=torch.uint8, device=device)
    steps = torch.arange(t, device=device, dtype=torch.float32)
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    for j in range(objects):
        # every seed the same object sizes and speeds; where they start, which
        # way they move and their colours come from the seed
        u = torch.rand((n, 5), generator=g, device=device)
        fh, fw = SIZES[j % len(SIZES)]
        oh, ow = int(h * fh), int(w * fw)
        vy = torch.where(u[:, 2:3] < 0.5, -SPEED, SPEED) * h
        vx = torch.where(u[:, 3:4] < 0.5, -SPEED, SPEED) * w
        y = _reflect(u[:, 0:1] * (h - oh) + vy * steps, torch.tensor(h - oh, device=device)).long()
        x = _reflect(u[:, 1:2] * (w - ow) + vx * steps, torch.tensor(w - ow, device=device)).long()
        in_r = (rows >= y[..., None]) & (rows < (y + oh)[..., None])  # (n, t, h)
        in_c = (cols >= x[..., None]) & (cols < (x + ow)[..., None])  # (n, t, w)
        mask = in_r[..., :, None] & in_c[..., None, :]
        color = (40 + 180 * torch.rand((n, 1, 1, 1, 3), generator=g, device=device)).to(torch.uint8)
        frames = torch.where(mask[..., None], color + (frames >> 3), frames)
        labels[mask] = j + 1
    return frames, labels


def lengths(traffic: dict, seed: int) -> List[int]:
    lo, hi = traffic["lengths"]
    n = traffic["pool"]
    ls = np.linspace(lo, hi, n).round().astype(int) if n > 1 else np.array([hi])
    return [int(x) for x in np.random.default_rng(seed).permutation(ls)]


def make_pool(traffic: dict, seed: int, device) -> List[Video]:
    """The traffic's pool of videos, in pool order."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = traffic["hw"]
    pool = []
    for length in lengths(traffic, seed):
        frames, labels = make_clips(g, 1, length, h, w, traffic["objects"], device)
        pool.append(Video(frames[0].cpu().numpy(), labels[0, 0].long().cpu().numpy()))
    return pool


def make_train_ring(traffic: dict, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``ring`` different batches of ``bs`` clips of ``frames`` frames at
    ``crop``², on ``device``: (uint8 frames (bs, T, crop, crop, 3), uint8
    palette-coloured annotations (bs, T, crop, crop, 3))."""
    g = torch.Generator(device=device).manual_seed(seed)
    bs, t, crop, ring = traffic["bs"], traffic["frames"], traffic["crop"], traffic["ring"]
    frames, labels = make_clips(g, bs * ring, t, crop, crop, traffic["objects"], device)
    colours = torch.as_tensor(palette()[: traffic["objects"] + 1], device=device)
    anns = colours[labels.long()]
    return [(frames[i * bs:(i + 1) * bs].contiguous(), anns[i * bs:(i + 1) * bs].contiguous()) for i in range(ring)]
