"""VOSNet: stride-8 backbone + 256-d embedding head (reference
``src/model/vos_net.py:9-54``).

  * ``resnet18``: the bare truncated backbone (it already ends at 256
    channels);
  * ``resnet50`` / ``resnet101``: backbone (1024 channels) → 1x1 conv
    ``adjust_dim`` to 256 → BatchNorm ``bn256``;
  * ``facebook``: the torchvision-shaped resnet50 (2048 channels) → the
    two 1x1 convs of ``adjust_dim`` (2048 → 1024 → 256, with no BN and no
    ReLU between them) → BatchNorm ``bn256``.

:func:`build_vos_net` also builds ``dino_vitb8``, DINO's ViT-B/8
(``models/vit.py``), whose 768-wide patch tokens take the place of the
embedding, and ``sam2_hiera_l``, SAM 2.1's Hiera-L image encoder
(``models/hiera.py``), whose 256-wide stride-16 neck level of the 2×
upsampled frame does.

``backbone`` is an ``nn.Sequential`` of the ResNet's first eight children,
so the state-dict keys are the reference's: ``backbone.0`` (conv1),
``backbone.1`` (bn1), ``backbone.4..7`` (layer1..4), ``adjust_dim``
(``adjust_dim.0`` / ``adjust_dim.1`` for facebook), ``bn256``.
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from semi_supervised_vos_tpu_torch.models.resnet import BatchNorm2d, resnet

RESNET_NAMES = ("resnet18", "resnet50", "resnet101", "facebook")
VIT_NAMES = ("dino_vitb8",)
HIERA_NAMES = ("sam2_hiera_l",)
# the frozen embedders: inference only, each with a bf16 card path of its own
FROZEN_NAMES = VIT_NAMES + HIERA_NAMES
MODEL_NAMES = RESNET_NAMES + FROZEN_NAMES


def build_vos_net(model: str = "resnet50") -> nn.Module:
    """The network ``model`` names: a :class:`VOSNet`, for ``dino_vitb8`` the
    ViT (``models/vit.py::DinoViT``, 768-wide features), for
    ``sam2_hiera_l`` SAM 2's Hiera (``models/hiera.py::SamHiera``, 256-wide
    features)."""
    if model in VIT_NAMES:
        from semi_supervised_vos_tpu_torch.models.vit import DinoViT

        return DinoViT(model)
    if model in HIERA_NAMES:
        from semi_supervised_vos_tpu_torch.models.hiera import SamHiera

        return SamHiera(model)
    return VOSNet(model)


class VOSNet(nn.Module):
    """256-d per-pixel embeddings: (B, 3, H, W) → (B, 256, ceil(H/8), ceil(W/8))."""

    def __init__(self, model: str = "resnet50"):
        super().__init__()
        if model not in RESNET_NAMES:
            raise NotImplementedError(f"model {model!r} is not a stride-8 ResNet; one of {RESNET_NAMES} "
                                      f"(build_vos_net builds every one of {MODEL_NAMES})")
        self.model = model
        self.backbone = nn.Sequential(*resnet(model).children_for_vos())
        if model == "facebook":
            self.adjust_dim = nn.Sequential(nn.Conv2d(2048, 1024, 1, bias=False), nn.Conv2d(1024, 256, 1, bias=False))
        elif model != "resnet18":
            self.adjust_dim = nn.Conv2d(1024, 256, 1, bias=False)
        if model != "resnet18":
            self.bn256 = BatchNorm2d(256)

    def forward(self, x):
        x = self.backbone(x)
        if self.model != "resnet18":
            x = self.bn256(self.adjust_dim(x))
        return x

    def frozen_backbone_mask(self) -> Dict[str, bool]:
        """Parameter name → trainable when the feature extractor is frozen
        (reference ``vos_net.py:53-54`` and ``train.py:124-128``): only the
        head trains, so a resnet18, which has none, trains nothing."""
        return {name: not name.startswith("backbone.") for name, _ in self.named_parameters()}
