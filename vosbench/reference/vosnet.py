"""The VOS network in plain float32 PyTorch: a stride-8 ResNet (He et al.,
arXiv:1512.03385; layer2 strided, layer3 and layer4 at stride 1, as Zhang
et al., arXiv:2004.07193, build it) and a 1x1 head to 256 channels with a
BatchNorm.

* ``resnet50``: every stage after the first 4x its width
  (64, 128, 256, 256), so layer4 ends at 1024 channels; head 1024 → 256;
* ``facebook``: the torchvision-shaped ResNet-50 of the SWSL weights
  (Yalniz et al., arXiv:1905.00546), stage widths (64, 128, 256, 512),
  layer4 ends at 2048; head 2048 → 1024 → 256, no BN or ReLU between.

The parameters are one flat dict under the published checkpoint's key
names (``backbone.0`` conv1, ``backbone.1`` bn1, ``backbone.4..7`` the
stages, ``adjust_dim``, ``bn256``), so the same tensors load into any
module that uses those names. :func:`forward` runs it with every product
in float32 (call it inside :func:`float32_exact`); ``round_to`` rounds every
activation to a lower precision after each convolution's BatchNorm, the
control's precision.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vosbench.counts import ARCH, EXPANSION, STAGE_STRIDES

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


def blocks(arch: str) -> List[Tuple[str, int, int, int, bool]]:
    """(key prefix, inplanes, planes, stride, has downsample) of every
    bottleneck block."""
    layers, planes = ARCH[arch]
    out, inplanes = [], 64
    for stage, (width, n, stride) in enumerate(zip(planes, layers, STAGE_STRIDES), start=1):
        for b in range(n):
            s = stride if b == 0 else 1
            ds = b == 0 and (s != 1 or inplanes != width * EXPANSION)
            out.append((f"backbone.{stage + 3}.{b}", inplanes, width, s, ds))
            inplanes = width * EXPANSION
    return out


def conv_shapes(arch: str) -> Dict[str, Tuple[int, int, int]]:
    """Key → (cout, cin, k) of every convolution weight."""
    shapes = {"backbone.0.weight": (64, 3, 7)}
    for name, cin, width, _, ds in blocks(arch):
        shapes[f"{name}.conv1.weight"] = (width, cin, 1)
        shapes[f"{name}.conv2.weight"] = (width, width, 3)
        shapes[f"{name}.conv3.weight"] = (width * EXPANSION, width, 1)
        if ds:
            shapes[f"{name}.downsample.0.weight"] = (width * EXPANSION, cin, 1)
    if arch == "facebook":
        shapes["adjust_dim.0.weight"] = (1024, 2048, 1)
        shapes["adjust_dim.1.weight"] = (256, 1024, 1)
    else:
        shapes["adjust_dim.weight"] = (256, 1024, 1)
    return shapes


def bn_shapes(arch: str) -> Dict[str, int]:
    """BatchNorm key prefix → channels, in forward order."""
    out = {"backbone.1": 64}
    for name, _, width, _, ds in blocks(arch):
        out[f"{name}.bn1"] = width
        out[f"{name}.bn2"] = width
        out[f"{name}.bn3"] = width * EXPANSION
        if ds:
            out[f"{name}.downsample.1"] = width * EXPANSION
    out["bn256"] = 256
    return out


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


def forward(sd: Dict[str, torch.Tensor], arch: str, x: torch.Tensor, bn: Optional[BatchNormFn] = None,
            round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N, 3, H, W) normalised frames → (N, 256, H/8, W/8) embeddings."""
    bn = bn or eval_bn(sd)

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    def conv(t, key, stride=1):
        w = sd[key]
        return F.conv2d(t, w, stride=stride, padding=w.shape[-1] // 2)

    x = rnd(F.relu(bn(conv(x, "backbone.0.weight", 2), "backbone.1")))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, _, _, s, ds in blocks(arch):
        y = rnd(F.relu(bn(conv(x, f"{name}.conv1.weight"), f"{name}.bn1")))
        y = rnd(F.relu(bn(conv(y, f"{name}.conv2.weight", s), f"{name}.bn2")))
        y = bn(conv(y, f"{name}.conv3.weight"), f"{name}.bn3")
        res = rnd(bn(conv(x, f"{name}.downsample.0.weight", s), f"{name}.downsample.1")) if ds else x
        x = rnd(F.relu(y + res))
    if arch == "facebook":
        x = rnd(conv(x, "adjust_dim.0.weight"))
        x = conv(x, "adjust_dim.1.weight")
    else:
        x = conv(x, "adjust_dim.weight")
    return rnd(bn(x, "bn256"))


def calibrate_bn(sd: Dict[str, torch.Tensor], arch: str, x: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input over
    ``x`` (one float32 pass that normalises with the batch's statistics): the
    mean and the unbiased variance, as one training-mode pass of a freshly
    reset ``torch.nn.BatchNorm2d`` with a cumulative average records them."""

    def bn(t, key):
        n = t.numel() // t.shape[1]
        var, mean = torch.var_mean(t, dim=(0, 2, 3), unbiased=False)
        sd[f"{key}.running_mean"].copy_(mean)
        sd[f"{key}.running_var"].copy_(var * n / (n - 1))
        sd[f"{key}.num_batches_tracked"].fill_(1)
        return F.batch_norm(t, None, None, sd[f"{key}.weight"], sd[f"{key}.bias"], True, 0.0, BN_EPS)

    with torch.no_grad():
        forward(sd, arch, x, bn)
