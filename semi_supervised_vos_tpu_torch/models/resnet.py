"""ResNet backbones with the reference's stride-8 VOS topology, as torch
modules with the reference's parameter names (``conv1``, ``bn1``,
``layer1..4``, blocks ``conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``).

Topology (reference ``src/model/backbone/resnet.py``):
  * stage strides (1, 2, 1, 1) → overall stride 8;
  * layer4 is built with ``planes=256``, so a bottleneck backbone ends at
    1024 channels and layer4's first block has no downsample branch
    (``inplanes == planes * 4`` and stride 1);
  * ``facebook`` (reference ``vos_net.py:29-38``, the torchvision-shaped
    resnet50 of the swsl weights, its strides patched to the same stride 8)
    keeps torchvision's widths (64, 128, 256, 512): it ends at 2048
    channels, and layer4's first block widens 1024 → 2048 through a
    downsample branch.

Layout is NCHW, the reference's.

Batch normalisation is :class:`BatchNorm2d`: in training it updates its
running variance with the biased batch variance, as the JAX package's flax
``BatchNorm`` does, where ``torch.nn.BatchNorm2d`` would use the unbiased
one.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGE_STRIDES = (1, 2, 1, 1)
# blocks per stage of each backbone; resnet34 and resnet152 are backbone
# factories only (:func:`resnet34`, :func:`resnet152`): VOSNet and the CLIs
# take the other four, as in the JAX package
ARCH_LAYERS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    "facebook": (3, 4, 6, 3),
}
BASIC_ARCHS = ("resnet18", "resnet34")  # basic blocks; the others bottlenecks
# stage widths of each arch (the JAX package's ``ARCH_PLANES``; resnet34's
# and resnet152's are ``ResNetBackbone``'s default)
ARCH_PLANES = {
    "resnet18": (64, 128, 256, 256),
    "resnet34": (64, 128, 256, 256),
    "resnet50": (64, 128, 256, 256),
    "resnet101": (64, 128, 256, 256),
    "resnet152": (64, 128, 256, 256),
    "facebook": (64, 128, 256, 512),
}


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward moves the running variance
    toward the **biased** batch variance, as flax ``BatchNorm`` (momentum
    0.9, the JAX package's ``resnet.py:219-227``) does; ``nn.BatchNorm2d``
    uses the unbiased one, n / (n - 1) times larger. ``momentum=None``
    (torch's cumulative average, which flax has no counterpart of) and
    evaluation keep torch's own behaviour. The state-dict keys are
    ``nn.BatchNorm2d``'s."""

    def forward(self, x):
        if not (self.training and self.track_running_stats and self.momentum is not None):
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        # batch_norm keeps the variance buffer it updates for its backward,
        # so it updates a copy: (1 - m) * var + m * v * n / (n - 1), v being
        # the biased batch variance, which is recovered without a second
        # pass over x
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(var - (var - (1.0 - self.momentum) * self.running_var) / n)
        return out


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    """Reference ``resnet.py:28-57``."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes, 1, stride), BatchNorm2d(planes))
            if downsample
            else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """Reference ``resnet.py:60-96`` (stride on the 3x3)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride), BatchNorm2d(planes * 4))
            if downsample
            else None
        )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


class ResNet(nn.Module):
    """conv1..layer4 of the VOS ResNet (the reference keeps children [0:8]):
    the JAX package's ``ResNetBackbone``."""

    def __init__(self, block: str, layers: Sequence[int], stage_planes: Sequence[int]):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (planes, blocks, stride) in enumerate(
            zip(stage_planes, layers, STAGE_STRIDES), start=1
        ):
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                has_ds = b == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                mods.append(block_cls(inplanes, planes, s, has_ds))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*mods))
        self.out_channels = inplanes

    def children_for_vos(self):
        """The eight children the reference's ``nn.Sequential`` keeps."""
        return [self.conv1, self.bn1, self.relu, self.maxpool,
                self.layer1, self.layer2, self.layer3, self.layer4]

    def forward(self, x):
        """(B, 3, H, W) → (B, out_channels, ceil(H/8), ceil(W/8)) (NCHW)."""
        for m in self.children_for_vos():
            x = m(x)
        return x


def resnet(model: str) -> ResNet:
    """resnet18 / resnet34 (basic blocks) or resnet50 / resnet101 /
    resnet152 / facebook (bottlenecks)."""
    if model not in ARCH_LAYERS:
        raise NotImplementedError(f"unknown model {model!r}")
    block = "basic" if model in BASIC_ARCHS else "bottleneck"
    return ResNet(block, ARCH_LAYERS[model], ARCH_PLANES[model])


def resnet18() -> ResNet:
    """Reference ``resnet.py:159-173`` (VOS topology, stride 8)."""
    return resnet("resnet18")


def resnet34() -> ResNet:
    """Reference ``resnet.py:176-184``."""
    return resnet("resnet34")


def resnet50() -> ResNet:
    """Reference ``resnet.py:187-200``."""
    return resnet("resnet50")


def resnet101() -> ResNet:
    """Reference ``resnet.py:203-216``."""
    return resnet("resnet101")


def resnet152() -> ResNet:
    """Reference ``resnet.py:219-227``."""
    return resnet("resnet152")


def out_spatial(h: int, w: int) -> Tuple[int, int]:
    """Stride-8 output size for an (h, w) input (torch conv arithmetic)."""

    def one(n: int) -> int:
        n = (n + 2 * 3 - 7) // 2 + 1  # conv1 k7 s2 p3
        n = (n + 2 * 1 - 3) // 2 + 1  # maxpool k3 s2 p1
        n = (n + 2 * 1 - 3) // 2 + 1  # layer2 first 3x3 s2 p1
        return n

    return one(h), one(w)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Reference initialisation (``resnet.py:134-140``) drawn from an explicit
    generator: convs ~ N(0, 2 / fan_out), BN weight 1 and bias 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()


def init_train_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX train CLI's initialisation, drawn from an explicit generator:
    every conv kernel flax ``lecun_normal`` (a normal of standard deviation
    sqrt(1 / fan_in) / 0.8796 truncated to two of those deviations, so its
    variance is 1 / fan_in), BN scale 1 and bias 0, running mean 0 and
    variance 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()
