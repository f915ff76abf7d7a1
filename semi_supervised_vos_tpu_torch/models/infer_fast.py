"""BN-folded inference forward of the VOSNet.

Replays ``VOSNet`` from the folded table of
:func:`semi_supervised_vos_tpu_torch.models.fold.fold_vosnet`:

  * every conv+BN pair is a conv with a bias;
  * the wide stride-1 bottlenecks without a downsample branch and with
    512 ≤ C ≤ 1024 (11 of resnet50's 16: layer2_1..3, layer3_1..5,
    layer4_0..2) run the fused bottleneck kernel
    (:func:`semi_supervised_vos_tpu_torch.ops.bottleneck.bottleneck_block`),
    whose C/4-wide intermediates never reach device memory — the dispatch
    is ``run_block``;
  * the stem, layer1, the stage-entry blocks and the head are cuDNN
    convolutions (``F.conv2d``), as the JAX package leaves them to XLA.

Activations are NCHW tensors in the channels-last memory format, so the
NHWC view the fused kernel takes is free.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from semi_supervised_vos_tpu_torch.models.resnet import ARCH_LAYERS, STAGE_PLANES, STAGE_STRIDES
from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block


def _conv(x, t: Dict, name: str, stride: int = 1) -> torch.Tensor:
    """Folded conv + bias (torch-style symmetric padding)."""
    k = t[f"{name}/kernel"]
    y = F.conv2d(x, k, stride=stride, padding=k.shape[-1] // 2)
    return y + t[f"{name}/bias"].to(y.dtype)[None, :, None, None]


def _basic_block(x, t: Dict, name: str, stride: int, downsample: bool):
    y = torch.relu(_conv(x, t, f"{name}/conv1", stride))
    y = _conv(y, t, f"{name}/conv2")
    residual = _conv(x, t, f"{name}/downsample", stride) if downsample else x
    return torch.relu(y + residual)


def _bottleneck(x, t: Dict, name: str, stride: int, downsample: bool):
    y = torch.relu(_conv(x, t, f"{name}/conv1"))
    y = torch.relu(_conv(y, t, f"{name}/conv2", stride))
    y = _conv(y, t, f"{name}/conv3")
    residual = _conv(x, t, f"{name}/downsample", stride) if downsample else x
    return torch.relu(y + residual)


def fast_encode(
    table: Dict,
    x: torch.Tensor,
    dtype=torch.bfloat16,
    arch: str = "resnet50",
) -> torch.Tensor:
    """Folded-weight VOSNet forward: (B, H, W, 3) normalised images, NHWC →
    (B, H/8, W/8, 256) embeddings, NHWC (a view of a channels-last tensor)."""
    basic = arch == "resnet18"

    def run_block(x, name, stride=1, downsample=False):
        if basic:
            return _basic_block(x, table, name, stride, downsample)
        c = x.shape[1]
        if downsample or stride != 1 or c < 512 or c > 1024:
            return _bottleneck(x, table, name, stride, downsample)
        y = bottleneck_block(x.permute(0, 2, 3, 1).contiguous(), *table[f"{name}/fused"])
        return y.permute(0, 3, 1, 2)

    x = x.to(dtype).permute(0, 3, 1, 2)  # channels-last NCHW view
    x = torch.relu(_conv(x, table, "stem", 2))
    x = F.max_pool2d(x, 3, stride=2, padding=1)

    expansion = 1 if basic else 4
    inplanes = 64
    for stage, (planes, blocks, stride) in enumerate(
        zip(STAGE_PLANES, ARCH_LAYERS[arch], STAGE_STRIDES), start=1
    ):
        for b in range(blocks):
            s = stride if b == 0 else 1
            has_ds = b == 0 and (s != 1 or inplanes != planes * expansion)
            x = run_block(x, f"layer{stage}_{b}", s, has_ds)
            inplanes = planes * expansion

    if not basic:
        x = _conv(x, table, "head")
    return x.permute(0, 2, 3, 1)
