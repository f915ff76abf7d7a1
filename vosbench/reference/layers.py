"""What every network family's plain reference shares: products in full
float32, the frames' ImageNet normalisation, and BatchNorm with the running
statistics, with the batch's, or recording the batch's as the running
ones. Each family's own network is its module's ``forward``
(``vosbench/networks/<family>.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def float32_exact():
    """Products and convolutions in full float32 (TF32 off) inside the
    block; both flags are restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 → (N, 3, H, W) float32, ImageNet-normalised."""
    x = frames_u8.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


BatchNormFn = Callable[[torch.Tensor, str], torch.Tensor]


def eval_bn(sd: Dict[str, torch.Tensor]) -> BatchNormFn:
    """BatchNorm with the running statistics."""
    return lambda x, key: F.batch_norm(x, sd[f"{key}.running_mean"], sd[f"{key}.running_var"],
                                       sd[f"{key}.weight"], sd[f"{key}.bias"], False, 0.0, BN_EPS)


def train_bn(sd: Dict[str, torch.Tensor]) -> BatchNormFn:
    """BatchNorm with the batch's statistics (biased variance)."""
    return lambda x, key: F.batch_norm(x, None, None, sd[f"{key}.weight"], sd[f"{key}.bias"], True, 0.0, BN_EPS)


def calibrating_bn(sd: Dict[str, torch.Tensor]) -> BatchNormFn:
    """BatchNorm that sets its running statistics to those of its input
    and normalises with the batch's: the mean and the unbiased variance, as
    one training-mode pass of a freshly reset ``torch.nn.BatchNorm2d`` with a
    cumulative average records them. A forward with it, under
    ``torch.no_grad()``, calibrates every BatchNorm on its frames."""

    def bn(t, key):
        n = t.numel() // t.shape[1]
        var, mean = torch.var_mean(t, dim=(0, 2, 3), unbiased=False)
        sd[f"{key}.running_mean"].copy_(mean)
        sd[f"{key}.running_var"].copy_(var * n / (n - 1))
        sd[f"{key}.num_batches_tracked"].fill_(1)
        return F.batch_norm(t, None, None, sd[f"{key}.weight"], sd[f"{key}.bias"], True, 0.0, BN_EPS)

    return bn
