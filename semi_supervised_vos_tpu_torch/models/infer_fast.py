"""BN-folded inference forward of the VOSNet.

Replays ``VOSNet`` from the folded table of
:func:`semi_supervised_vos_tpu_torch.models.fold.fold_vosnet`:

  * every conv+BN pair is a conv with a bias;
  * the wide stride-1 bottlenecks without a downsample branch and with
    512 ≤ C ≤ 1024 run the fused bottleneck kernel
    (:func:`semi_supervised_vos_tpu_torch.ops.bottleneck.bottleneck_block`),
    whose C/4-wide intermediates never reach device memory — the dispatch
    is ``run_block``. That is 11 of resnet50's 16 blocks (layer2_1..3,
    layer3_1..5, layer4_0..2) and 8 of facebook's 16 (layer2_1..3,
    layer3_1..5: its layer4 is 2048 wide);
  * the stem, layer1, the stage-entry blocks, facebook's layer4 and the
    head (facebook's two convs: ``head0``, then ``head``) are library
    convolutions, as the JAX package leaves them to XLA: the 3x3 ones
    ``F.conv2d``, the 1x1 ones products over the channels (``_conv1x1``)
    with a float32 result, to which the bias, the residual and the ReLU are
    applied before one rounding to the activation dtype, as the fused kernel
    rounds its block output once (and as XLA, allowed excess precision,
    fuses the JAX package's bias and residual adds into the product);
  * the stem (7x7, 3 input channels, 1 % of the FLOPs) runs on the float32
    image with a float32 kernel, in full float32 whatever the caller's TF32
    flags, and its max-pooled output is rounded once.

With a bf16 image, stem kernel and a rounding after each step, facebook's
bf16 encoder fell below the 0.9999 cosine gate at 480p (0.999895 on an H100).

Activations are NCHW tensors in the channels-last memory format, so the
NHWC view the fused kernel takes, and the (pixels, channels) matrix of a 1x1
conv, are free.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn.functional as F

from semi_supervised_vos_tpu_torch.models.resnet import ARCH_LAYERS, ARCH_PLANES, STAGE_STRIDES
from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block


def _conv(x, t: Dict, name: str, stride: int = 1) -> torch.Tensor:
    """Folded conv + bias (torch-style symmetric padding)."""
    k = t[f"{name}/kernel"]
    y = F.conv2d(x, k, stride=stride, padding=k.shape[-1] // 2)
    return y + t[f"{name}/bias"].to(y.dtype)[None, :, None, None]


@contextlib.contextmanager
def _full_float32():
    """Float32 convolutions and products in full float32 (no TF32) inside
    the block; both of PyTorch's TF32 flags are restored on exit, also on an
    exception."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _conv1x1(x, t: Dict, name: str, stride: int = 1, residual=None, relu: bool = False, dtype=None):
    """Folded 1x1 conv as one product over the channels: the float32 result
    of the operands plus the bias (the GEMM's epilogue on the card), plus
    ``residual``, rounded once to ``dtype`` (x's by default), then the ReLU
    (which commutes with the rounding)."""
    k = t[f"{name}/kernel"]
    if stride != 1:
        x = x[:, :, ::stride, ::stride]
    n, c, h, w = x.shape
    a, b = x.permute(0, 2, 3, 1).reshape(-1, c), k.reshape(k.shape[0], c).t()
    if a.is_cuda and a.dtype != torch.float32:
        y = torch.addmm(t[f"{name}/bias"], a, b, out_dtype=torch.float32)
    else:
        y = torch.addmm(t[f"{name}/bias"], a.float(), b.float())
    dtype = dtype or x.dtype
    if residual is not None:
        y = torch.add(y, residual.permute(0, 2, 3, 1).reshape(y.shape), out=torch.empty_like(y, dtype=dtype))
    else:
        y = y.to(dtype)
    if relu:
        y.relu_()
    return y.view(n, h, w, -1).permute(0, 3, 1, 2)


def _basic_block(x, t: Dict, name: str, stride: int, downsample: bool):
    y = torch.relu(_conv(x, t, f"{name}/conv1", stride))
    y = _conv(y, t, f"{name}/conv2")
    residual = _conv(x, t, f"{name}/downsample", stride) if downsample else x
    return torch.relu(y + residual)


def _bottleneck(x, t: Dict, name: str, stride: int, downsample: bool):
    y = _conv1x1(x, t, f"{name}/conv1", relu=True)
    y = torch.relu(_conv(y, t, f"{name}/conv2", stride))
    residual = _conv1x1(x, t, f"{name}/downsample", stride, dtype=torch.float32) if downsample else x
    return _conv1x1(y, t, f"{name}/conv3", residual=residual, relu=True)


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

    x = x.float().permute(0, 3, 1, 2)  # channels-last NCHW view
    with _full_float32():
        x = _conv(x, table, "stem", 2).relu_()
    x = F.max_pool2d(x, 3, stride=2, padding=1).to(dtype)

    expansion = 1 if basic else 4
    inplanes = 64
    for stage, (planes, blocks, stride) in enumerate(
        zip(ARCH_PLANES[arch], ARCH_LAYERS[arch], STAGE_STRIDES), start=1
    ):
        for b in range(blocks):
            s = stride if b == 0 else 1
            has_ds = b == 0 and (s != 1 or inplanes != planes * expansion)
            x = run_block(x, f"layer{stage}_{b}", s, has_ds)
            inplanes = planes * expansion

    if arch == "facebook":
        x = _conv1x1(x, table, "head0")  # no BN, no ReLU before the next conv
    if not basic:
        x = _conv1x1(x, table, "head")
    return x.permute(0, 2, 3, 1)
