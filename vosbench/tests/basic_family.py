"""A second network family, for the registry's test that a new family is
one new module: ResNets of basic blocks (two 3x3 convolutions a block, He
et al., arXiv:1512.03385) at stride 8, with no head, so the features are
the last stage's output, as the port's ``resnet18`` VOS network gives them.
The test copies this file into a copy of the benchmark as
``vosbench/networks/basic.py``; what it shares with the bottleneck family
it takes from ``vosbench/networks/resnet.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vosbench.networks import resnet
from vosbench.reference.layers import BatchNormFn, calibrating_bn, eval_bn, float32_exact, normalize

KEYS = ("model", "layers", "stage_planes", "stage_strides", "feature_dim", "output_stride")
feature_hw = resnet.feature_hw
parameter_keys = resnet.parameter_keys
program_net = resnet.program_net


def check(cfg: dict) -> None:
    missing = [k for k in KEYS if k not in cfg]
    if missing:
        raise ValueError(f"configuration {cfg.get('model')!r}: the basic family needs the key(s) {', '.join(missing)}")
    if not len(cfg["layers"]) == len(cfg["stage_planes"]) == len(cfg["stage_strides"]) > 0:
        raise ValueError(f"configuration {cfg['model']!r}: the stages' keys differ in length")
    if cfg["feature_dim"] != cfg["stage_planes"][-1] or cfg["output_stride"] != 4 * math.prod(cfg["stage_strides"]):
        raise ValueError(f"configuration {cfg['model']!r}: feature_dim or output_stride does not follow the stages")


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    out, inplanes = [], resnet.STEM
    for stage, (width, n, stride) in enumerate(zip(cfg["stage_planes"], cfg["layers"], cfg["stage_strides"]), start=1):
        for b in range(n):
            s = stride if b == 0 else 1
            out.append((f"backbone.{stage + 3}.{b}", inplanes, width, s, b == 0 and (s != 1 or inplanes != width)))
            inplanes = width
    return out


def frame_flops(cfg: dict, h: int, w: int) -> float:
    conv_out = resnet.conv_out
    oh, ow = conv_out(h, 7, 2), conv_out(w, 7, 2)
    convs = [(3, resnet.STEM, 7, oh, ow)]
    oh, ow = conv_out(oh, 3, 2), conv_out(ow, 3, 2)
    for _, cin, width, s, ds in blocks(cfg):
        bh, bw = conv_out(oh, 3, s), conv_out(ow, 3, s)
        convs += [(cin, width, 3, bh, bw), (width, width, 3, bh, bw)] + ([(cin, width, 1, bh, bw)] if ds else [])
        oh, ow = bh, bw
    return float(sum(2.0 * oh * ow * cin * cout * k * k for cin, cout, k, oh, ow in convs))


def train_forward_flops(cfg: dict, n: int, crop: int) -> float:
    return n * frame_flops(cfg, crop, crop)


def _draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    convs, bns = {"backbone.0.weight": (resnet.STEM, 3, 7)}, {"backbone.1": resnet.STEM}
    for name, cin, width, _, ds in blocks(cfg):
        convs[f"{name}.conv1.weight"] = (width, cin, 3)
        convs[f"{name}.conv2.weight"] = (width, width, 3)
        bns[f"{name}.bn1"] = bns[f"{name}.bn2"] = width
        if ds:
            convs[f"{name}.downsample.0.weight"] = (width, cin, 1)
            bns[f"{name}.downsample.1"] = width
    sd = resnet.draw(convs, bns, seed, device)
    for key in bns:
        if key.endswith(".bn2"):  # a basic block's branch ends in bn2
            sd[f"{key}.weight"].mul_(0.1)
    return sd


def train_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(cfg, seed, device)


def inference_weights(cfg: dict, seed: int, frames_u8: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    sd = _draw(cfg, seed, device)
    with float32_exact(), torch.no_grad():
        forward(sd, cfg, normalize(frames_u8), calibrating_bn(sd))
    return sd


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, bn: Optional[BatchNormFn] = None,
            round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    bn = bn or eval_bn(sd)

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    def conv(t, key, stride=1):
        w = sd[key]
        return F.conv2d(t, w, stride=stride, padding=w.shape[-1] // 2)

    x = rnd(F.relu(bn(conv(x, "backbone.0.weight", 2), "backbone.1")))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, _, _, s, ds in blocks(cfg):
        y = rnd(F.relu(bn(conv(x, f"{name}.conv1.weight", s), f"{name}.bn1")))
        y = bn(conv(y, f"{name}.conv2.weight"), f"{name}.bn2")
        res = rnd(bn(conv(x, f"{name}.downsample.0.weight", s), f"{name}.downsample.1")) if ds else x
        x = rnd(F.relu(y + res))
    return x


def wrap(tracer) -> None:
    """No kernel of its own: the port runs basic blocks on cuDNN."""
