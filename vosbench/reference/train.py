"""The cross-entropy training step in plain float32 PyTorch (reference code
``src/train.py:155-216`` and ``src/model/loss.py:13-66``): the VOS network
(its family module's plain ``forward``) over every frame of B clips in
training mode (BatchNorm on the batch's statistics), the annotations
brought to the feature grid by nearest resize and quantised to the
nearest of the 22 palette colours, the last frame's labels propagated
from the T − 1 earlier frames by a softmax over all their pixels, the mean
negative log-likelihood, and one step of SGD with Nesterov momentum 0.9 and
weight decay 3e-4 added to the gradient (``src/train.py:75-81``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from vosbench.reference.layers import normalize, train_bn

EPS = 1e-14
LR, MOMENTUM, WEIGHT_DECAY = 0.02, 0.9, 3e-4


def palette(n: int = 256) -> np.ndarray:
    """The DAVIS / PASCAL VOC palette, (n, 3) uint8 (bit reversal)."""
    out = np.zeros((n, 3), np.uint8)
    for i in range(n):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        out[i] = (r, g, b)
    return out


def centroids() -> np.ndarray:
    """The 22 class colours, 192 stored as 191 as the reference's
    ``annotation_centroids.npy`` holds them."""
    table = palette()[:22].astype(np.int32)
    table[table == 192] = 191
    return table


def annotation_classes(anns: torch.Tensor, hd: int, wd: int) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 → (B, T, hd, wd) class indices: nearest resize
    (``floor(o * in / out)``), then the nearest colour."""
    h, w = anns.shape[2:4]
    rows = torch.as_tensor(np.minimum(np.arange(hd) * h // hd, h - 1), device=anns.device)
    cols = torch.as_tensor(np.minimum(np.arange(wd) * w // wd, w - 1), device=anns.device)
    small = anns.index_select(2, rows).index_select(3, cols).float()
    c = torch.as_tensor(centroids(), dtype=torch.float32, device=anns.device)
    return torch.argmin(((small[..., None, :] - c) ** 2).sum(-1), dim=-1)


def loss_fn(params: Dict[str, torch.Tensor], network, cfg: dict, imgs: torch.Tensor, anns: torch.Tensor,
            num_classes: int = 22, round_to=None) -> torch.Tensor:
    b, t = imgs.shape[:2]
    x = normalize(imgs.reshape(-1, *imgs.shape[2:]))
    feats = network.forward(params, cfg, x, train_bn(params), round_to).float().permute(0, 2, 3, 1)
    hd, wd, c = feats.shape[1:]
    feats = feats.reshape(b, t, hd * wd, c)
    cls = annotation_classes(anns, hd, wd).reshape(b, t, hd * wd)
    ref = feats[:, : t - 1].reshape(b, -1, c)  # (B, R·P, C)
    sim = torch.bmm(ref, feats[:, -1].transpose(1, 2))  # (B, R·P, P)
    onehot = torch.nn.functional.one_hot(cls[:, : t - 1].reshape(b, -1), num_classes).float()
    pred = torch.bmm(torch.softmax(sim, dim=1).transpose(1, 2), onehot)  # (B, P, D)
    logp = torch.log(pred + EPS)
    return -torch.gather(logp, -1, cls[:, -1, :, None])[..., 0].mean()


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor]) -> None:
    """One SGD step with Nesterov momentum and coupled weight decay, in
    place; ``bufs`` holds the momentum (filled on the first step)."""
    with torch.no_grad():
        for k, p in params.items():
            d_p = grads[k] + WEIGHT_DECAY * p
            if k not in bufs:
                bufs[k] = d_p.clone()
            else:
                bufs[k].mul_(MOMENTUM).add_(d_p)
            p.sub_(LR * (d_p + MOMENTUM * bufs[k]))


def run_steps(params: Dict[str, torch.Tensor], network, cfg: dict, batches: List[Tuple[torch.Tensor, torch.Tensor]],
              round_to=None) -> Tuple[List[float], Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Train ``params`` (float32 leaves, changed in place) over ``batches``:
    → (each step's loss, the first step's gradient as the optimizer takes
    it, g + weight decay · p, and the raw first gradient)."""
    bufs: Dict[str, torch.Tensor] = {}
    losses, first, raw = [], None, None
    for step, (imgs, anns) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, network, cfg, imgs, anns, round_to=round_to)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        sgd_step(params, grads, bufs)
        if step == 0:
            first = {k: v.clone() for k, v in bufs.items()}
            raw = grads
        del leaves, grads, loss
    return losses, first, raw
