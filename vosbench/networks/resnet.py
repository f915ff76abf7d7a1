"""The stride-8 ResNet family: bottleneck ResNets (He et al.,
arXiv:1512.03385) with layer2 strided and layer3 and layer4 at stride 1, as
Zhang et al., arXiv:2004.07193, build them, and a head of 1x1 convolutions
to the feature width with a BatchNorm.

The architecture is read from the configuration's own keys:

* ``layers``: bottleneck blocks per stage; ``stage_planes``: each stage's
  width; ``stage_strides``: each stage's stride (its first block's 3x3);
  ``expansion``: a block's output channels over its width;
* ``backbone_channels``: the last stage's output, ``stage_planes[-1]`` x
  ``expansion``;
* ``head``: the head's 1x1 convolutions as [cin, cout] pairs, with no BN
  or ReLU between them, from ``backbone_channels`` to ``feature_dim``,
  which a BatchNorm then normalises;
* ``output_stride``: 4 (the stem and its max-pool) x the stage strides.

The parameters are one flat dict under the published checkpoint's key
names (``backbone.0`` conv1, ``backbone.1`` bn1, ``backbone.4..7`` the
stages, ``adjust_dim`` for a head of one convolution or ``adjust_dim.<i>``
for several, ``bn256``), so the same tensors load into the port's module.

Weights are made on the card from the seed in a few large calls: every
convolution ~ N(0, 2 / fan_out) (He et al.'s initialisation, the
reference's ``resnet.py:134-140``), BatchNorm scales ~ N(1, 0.1) and shifts
~ N(0, 0.1), each residual branch's last BatchNorm scale cut to a tenth.
For inference the BatchNorm statistics are then estimated on the cell's own
frames (one float32 pass), as a trained network's would match its data.
Without the cut and the estimate a random ResNet's features all but share
one direction and every propagated mask is background.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vosbench.counts import PEAK_BF16_FLOPS, bound_s
from vosbench.reference.layers import BatchNormFn, calibrating_bn, eval_bn, float32_exact, normalize

KEYS = ("model", "layers", "stage_planes", "stage_strides", "expansion", "backbone_channels", "head",
        "feature_dim", "output_stride")
STEM = 64  # the stem's output channels, layer1's input


def check(cfg: dict) -> None:
    """Raise ``ValueError`` naming each missing or inconsistent key."""
    missing = [k for k in KEYS if k not in cfg]
    if missing:
        raise ValueError(f"configuration {cfg.get('model')!r}: the resnet family needs the key(s) {', '.join(missing)}")
    layers, planes, strides, head = cfg["layers"], cfg["stage_planes"], cfg["stage_strides"], cfg["head"]
    problems = []
    if not len(layers) == len(planes) == len(strides) > 0:
        problems.append(f"layers, stage_planes and stage_strides have {len(layers)}, {len(planes)} and "
                        f"{len(strides)} stages")
    else:
        if cfg["backbone_channels"] != planes[-1] * cfg["expansion"]:
            problems.append(f"backbone_channels {cfg['backbone_channels']} is not stage_planes[-1] x expansion "
                            f"({planes[-1]} x {cfg['expansion']})")
        if cfg["output_stride"] != 4 * math.prod(strides):
            problems.append(f"output_stride {cfg['output_stride']} is not 4 x the stage strides {strides}")
    pairs = bool(head) and all(isinstance(pair, list) and len(pair) == 2 for pair in head)
    chain = [cfg["backbone_channels"]] + [c for pair in head for c in pair] + [cfg["feature_dim"]] if pairs else []
    if not pairs or chain[0::2] != chain[1::2]:
        problems.append(f"head {head} does not lead from backbone_channels {cfg['backbone_channels']} "
                        f"to feature_dim {cfg['feature_dim']}")
    if problems:
        raise ValueError(f"configuration {cfg['model']!r}: " + "; ".join(problems))


def conv_out(n: int, k: int, s: int) -> int:
    return (n + 2 * (k // 2) - k) // s + 1


def feature_hw(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The feature grid of an (h, w) frame: conv1 (7, stride 2), the
    max-pool (3, stride 2), each stage's first 3x3."""

    def grid(n: int) -> int:
        n = conv_out(conv_out(n, 7, 2), 3, 2)
        for s in cfg["stage_strides"]:
            n = conv_out(n, 3, s)
        return n

    return grid(h), grid(w)


def blocks(cfg: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(key prefix, inplanes, planes, stride, has downsample) of every
    bottleneck block."""
    e = cfg["expansion"]
    out, inplanes = [], STEM
    for stage, (width, n, stride) in enumerate(zip(cfg["stage_planes"], cfg["layers"], cfg["stage_strides"]), start=1):
        for b in range(n):
            s = stride if b == 0 else 1
            ds = b == 0 and (s != 1 or inplanes != width * e)
            out.append((f"backbone.{stage + 3}.{b}", inplanes, width, s, ds))
            inplanes = width * e
    return out


def head_keys(cfg: dict) -> List[str]:
    """The head convolutions' weight keys, in order."""
    n = len(cfg["head"])
    return ["adjust_dim.weight"] if n == 1 else [f"adjust_dim.{i}.weight" for i in range(n)]


def convs(cfg: dict, h: int, w: int) -> List[Tuple[int, int, int, int, int]]:
    """Every convolution of one forward of an (h, w) frame, in order: (cin,
    cout, k, out_h, out_w)."""
    e = cfg["expansion"]
    oh, ow = conv_out(h, 7, 2), conv_out(w, 7, 2)
    out = [(3, STEM, 7, oh, ow)]
    oh, ow = conv_out(oh, 3, 2), conv_out(ow, 3, 2)
    for _, cin, width, s, ds in blocks(cfg):
        out.append((cin, width, 1, oh, ow))
        bh, bw = conv_out(oh, 3, s), conv_out(ow, 3, s)
        out.append((width, width, 3, bh, bw))
        out.append((width, width * e, 1, bh, bw))
        if ds:
            out.append((cin, width * e, 1, bh, bw))
        oh, ow = bh, bw
    out += [(cin, cout, 1, oh, ow) for cin, cout in cfg["head"]]
    return out


def frame_flops(cfg: dict, h: int, w: int) -> float:
    """Multiply-adds x 2 of every convolution of one (h, w) frame."""
    return float(sum(2.0 * oh * ow * cin * cout * k * k for cin, cout, k, oh, ow in convs(cfg, h, w)))


def train_forward_flops(cfg: dict, n: int, crop: int) -> float:
    """The forward's operations over ``n`` crops of crop x crop."""
    return n * frame_flops(cfg, crop, crop)


def bottleneck_call(n: int, h: int, w: int, c: int, c4: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one fused bottleneck block over (n, h, w, c)
    activations: its three convolutions, the input and output once, the
    weights once."""
    flops = 2.0 * n * h * w * (c * c4 + 9 * c4 * c4 + c4 * c)
    nbytes = 2.0 * n * h * w * c * elem_bytes + (c * c4 + 9 * c4 * c4 + c4 * c) * elem_bytes
    return flops, nbytes


def bottleneck_call_bound(n: int, h: int, w: int, c: int, c4: int) -> float:
    flops, nbytes = bottleneck_call(n, h, w, c, c4)
    return bound_s([(flops, PEAK_BF16_FLOPS)], nbytes)


def conv_shapes(cfg: dict) -> Dict[str, Tuple[int, int, int]]:
    """Key → (cout, cin, k) of every convolution weight."""
    e = cfg["expansion"]
    shapes = {"backbone.0.weight": (STEM, 3, 7)}
    for name, cin, width, _, ds in blocks(cfg):
        shapes[f"{name}.conv1.weight"] = (width, cin, 1)
        shapes[f"{name}.conv2.weight"] = (width, width, 3)
        shapes[f"{name}.conv3.weight"] = (width * e, width, 1)
        if ds:
            shapes[f"{name}.downsample.0.weight"] = (width * e, cin, 1)
    for key, (cin, cout) in zip(head_keys(cfg), cfg["head"]):
        shapes[key] = (cout, cin, 1)
    return shapes


def bn_shapes(cfg: dict) -> Dict[str, int]:
    """BatchNorm key prefix → channels, in forward order."""
    e = cfg["expansion"]
    out = {"backbone.1": STEM}
    for name, _, width, _, ds in blocks(cfg):
        out[f"{name}.bn1"] = width
        out[f"{name}.bn2"] = width
        out[f"{name}.bn3"] = width * e
        if ds:
            out[f"{name}.downsample.1"] = width * e
    out["bn256"] = cfg["feature_dim"]
    return out


def draw(convs: Dict[str, Tuple[int, int, int]], bns: Dict[str, int], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights from ``seed``: one normal draw for all convolutions (``convs``:
    key → (cout, cin, k)) and one for all BatchNorm affine parameters
    (``bns``: key prefix → channels), the scale of each residual branch's
    last BatchNorm (``.bn3``) cut to a tenth."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = [co * ci * k * k for co, ci, k in convs.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for (key, (co, ci, k)), chunk in zip(convs.items(), torch.split(flat, sizes)):
        sd[key] = (chunk * (2.0 / (co * k * k)) ** 0.5).view(co, ci, k, k)
    affine = torch.randn(2 * sum(bns.values()), generator=g, device=device) * 0.1
    scales, shifts = torch.split(affine, [sum(bns.values())] * 2)
    for (key, c), scale, shift in zip(bns.items(), torch.split(scales, list(bns.values())),
                                      torch.split(shifts, list(bns.values()))):
        cut = 0.1 if key.endswith(".bn3") else 1.0
        sd[f"{key}.weight"] = (scale + 1.0) * cut
        sd[f"{key}.bias"] = shift.clone()
        sd[f"{key}.running_mean"] = torch.zeros(c, device=device)
        sd[f"{key}.running_var"] = torch.ones(c, device=device)
        sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return sd


# the training head's BatchNorm scale and shift, as a share of the drawn ones
TRAIN_HEAD_SCALE = 0.03


def train_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The drawn weights with the head's BatchNorm scale and shift cut to
    ``TRAIN_HEAD_SCALE``: features of norm ~0.5 rather than ~16, so that the
    loss's softmax over the reference pixels is not one-hot. With one-hot
    rows the loss's gradient rests on the few pixels whose two best matches
    tie, and any rounding, TF32 as much as bfloat16, moves it by whole
    pixels."""
    sd = draw(conv_shapes(cfg), bn_shapes(cfg), seed, device)
    sd["bn256.weight"].mul_(TRAIN_HEAD_SCALE)
    sd["bn256.bias"].mul_(TRAIN_HEAD_SCALE)
    return sd


def inference_weights(cfg: dict, seed: int, frames_u8: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """The drawn weights with the BatchNorm statistics of ``frames_u8``
    ((N, H, W, 3) uint8 on ``device``)."""
    sd = draw(conv_shapes(cfg), bn_shapes(cfg), seed, device)
    with float32_exact(), torch.no_grad():
        forward(sd, cfg, normalize(frames_u8), calibrating_bn(sd))
    return sd


def parameter_keys(sd: Dict[str, torch.Tensor]) -> List[str]:
    """The trainable leaves: convolution weights, BatchNorm scales and
    shifts (not the running statistics)."""
    return [k for k in sd if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, bn: Optional[BatchNormFn] = None,
            round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain reference: (N, 3, H, W) normalised frames → (N,
    feature_dim, H/8, W/8) embeddings, every product in float32 (call it
    inside ``float32_exact``); ``round_to`` rounds every activation to a
    lower precision after each convolution's BatchNorm, the control's
    precision."""
    bn = bn or eval_bn(sd)

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    def conv(t, key, stride=1):
        w = sd[key]
        return F.conv2d(t, w, stride=stride, padding=w.shape[-1] // 2)

    x = rnd(F.relu(bn(conv(x, "backbone.0.weight", 2), "backbone.1")))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for name, _, _, s, ds in blocks(cfg):
        y = rnd(F.relu(bn(conv(x, f"{name}.conv1.weight"), f"{name}.bn1")))
        y = rnd(F.relu(bn(conv(y, f"{name}.conv2.weight", s), f"{name}.bn2")))
        y = bn(conv(y, f"{name}.conv3.weight"), f"{name}.bn3")
        res = rnd(bn(conv(x, f"{name}.downsample.0.weight", s), f"{name}.downsample.1")) if ds else x
        x = rnd(F.relu(y + res))
    keys = head_keys(cfg)
    for key in keys[:-1]:
        x = rnd(conv(x, key))
    x = conv(x, keys[-1])
    return rnd(bn(x, "bn256"))


def program_net(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """The port's VOS network with ``sd`` loaded, as the CLI builds it."""
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    with torch.device("meta"):
        net = VOSNet(cfg["model"])
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    return net


def wrap(tracer) -> None:
    """The encoder's own ranges and claims (traced run): the fused
    bottleneck kernel, launched inside the driver's ``encode`` and
    ``dispatch`` ranges, and each call's shapes for its roofline."""
    from semi_supervised_vos_tpu_torch.models import infer_fast

    tracer.claim("bottleneck_kernel<", ("bottleneck", "encode", "dispatch"))
    tracer.wrap(infer_fast, "bottleneck_block", "bottleneck",
                lambda a, k: {"shape": tuple(a[0].shape), "c4": int(a[1].shape[1])})
