"""The networks' weights, made on the card from the seed in a few large
calls: every convolution ~ N(0, 2 / fan_out) (He et al.'s initialisation,
the reference's ``resnet.py:134-140``), BatchNorm scales ~ N(1, 0.1) and
shifts ~ N(0, 0.1), each residual branch's last BatchNorm scale cut to a
tenth. For inference the BatchNorm statistics are then estimated on the
cell's own frames (one float32 pass), as a trained network's would match
its data. Without the cut and the estimate a random ResNet's features all
but share one direction and every propagated mask is background.

The result is a flat state dict under the published key names, which the
plain reference reads and the program under test loads.
"""

from __future__ import annotations

from typing import Dict

import torch

from vosbench.reference.vosnet import bn_shapes, calibrate_bn, conv_shapes, float32_exact, normalize


def make_state_dict(arch: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights of ``arch`` from ``seed``: one normal draw for all
    convolutions and one for all BatchNorm affine parameters."""
    g = torch.Generator(device=device).manual_seed(seed)
    convs = conv_shapes(arch)
    sizes = [co * ci * k * k for co, ci, k in convs.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for (key, (co, ci, k)), chunk in zip(convs.items(), torch.split(flat, sizes)):
        sd[key] = (chunk * (2.0 / (co * k * k)) ** 0.5).view(co, ci, k, k)
    bns = bn_shapes(arch)
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


def train_state_dict(arch: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """:func:`make_state_dict` with the head's BatchNorm scale and shift cut
    to ``TRAIN_HEAD_SCALE``: features of norm ~0.5 rather than ~16, so that the
    loss's softmax over the reference pixels is not one-hot. With one-hot
    rows the loss's gradient rests on the few pixels whose two best matches
    tie, and any rounding, TF32 as much as bfloat16, moves it by whole
    pixels."""
    sd = make_state_dict(arch, seed, device)
    sd["bn256.weight"].mul_(TRAIN_HEAD_SCALE)
    sd["bn256.bias"].mul_(TRAIN_HEAD_SCALE)
    return sd


def inference_state_dict(arch: str, seed: int, frames_u8: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """:func:`make_state_dict` with the BatchNorm statistics of
    ``frames_u8`` ((N, H, W, 3) uint8 on ``device``)."""
    sd = make_state_dict(arch, seed, device)
    with float32_exact():
        calibrate_bn(sd, arch, normalize(frames_u8))
    return sd


def parameter_keys(sd: Dict[str, torch.Tensor]):
    """The trainable leaves: convolution weights, BatchNorm scales and
    shifts (not the running statistics)."""
    return [k for k in sd if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
