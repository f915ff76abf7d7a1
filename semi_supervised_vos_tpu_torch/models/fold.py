"""BatchNorm folding for inference.

At inference BN is a per-channel affine map ``y = (x − μ)·γ/√(σ²+ε) + β``;
folding scales the preceding conv's output channels by ``γ/√(σ²+ε)`` and
turns the rest into a bias. The folded table feeds
:func:`semi_supervised_vos_tpu_torch.models.infer_fast.fast_encode`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck
from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
from semi_supervised_vos_tpu_torch.ops.bottleneck import KERNEL_C4, tf32_split_weights

BN_EPS = 1e-5  # torch BatchNorm2d default


def fold_conv_bn(weight: torch.Tensor, bn: nn.BatchNorm2d, eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cout, cin, kh, kw) kernel + BN → (kernel', bias'), float32."""
    gamma = bn.weight.detach().float()
    beta = bn.bias.detach().float()
    mean = bn.running_mean.detach().float()
    var = bn.running_var.detach().float()
    inv_std = gamma / torch.sqrt(var + eps)
    return weight.detach().float() * inv_std[:, None, None, None], beta - mean * inv_std


def fold_vosnet(net: VOSNet, dtype=torch.bfloat16) -> Dict[str, object]:
    """Fold every conv+BN pair of ``net`` (on its device).

    Returns a flat dict: ``stem/{kernel,bias}`` (float32: ``fast_encode``
    runs the stem in float32),
    ``layer<S>_<B>/{conv1,conv2[,conv3],downsample}/{kernel,bias}`` (OIHW
    kernels in ``dtype``, float32 biases), ``head/{kernel,bias}`` (absent for
    resnet18; for facebook ``adjust_dim.1`` folded with ``bn256``, after
    ``head0/{kernel,bias}``, the bare 2048 → 1024 ``adjust_dim.0`` with a
    zero bias), and for every bottleneck block without a downsample branch
    ``layer<S>_<B>/fused``: the fused kernel's operands (w1 (C, C4), b1,
    w2 (3, 3, C4, C4) HWIO, b2, w3 (C4, C), b3), prepared once here; in a
    float32 table, where C4 is a width the kernel takes (``KERNEL_C4``),
    also ``layer<S>_<B>/fused_tf32``: those weights K-major and split into
    tf32 big / small planes (:func:`~semi_supervised_vos_tpu_torch.ops.
    bottleneck.tf32_split_weights`), the kernel's 3xTF32 operands.
    """
    seq = net.backbone
    out: Dict[str, object] = {}

    def put(name, weight, bn, kernel_dtype=dtype):
        k, b = fold_conv_bn(weight, bn)
        out[f"{name}/kernel"] = k.to(kernel_dtype).contiguous(memory_format=torch.channels_last)
        out[f"{name}/bias"] = b
        return k, b

    put("stem", seq[0].weight, seq[1], torch.float32)
    for stage in range(1, 5):
        for b, blk in enumerate(seq[stage + 3]):
            name = f"layer{stage}_{b}"
            folded = [put(f"{name}/conv1", blk.conv1.weight, blk.bn1),
                      put(f"{name}/conv2", blk.conv2.weight, blk.bn2)]
            if isinstance(blk, Bottleneck):
                folded.append(put(f"{name}/conv3", blk.conv3.weight, blk.bn3))
            if blk.downsample is not None:
                put(f"{name}/downsample", blk.downsample[0].weight, blk.downsample[1])
            elif isinstance(blk, Bottleneck):
                (k1, b1), (k2, b2), (k3, b3) = folded
                out[f"{name}/fused"] = (
                    k1[:, :, 0, 0].t().to(dtype).contiguous(), b1,
                    k2.permute(2, 3, 1, 0).to(dtype).contiguous(), b2,
                    k3[:, :, 0, 0].t().to(dtype).contiguous(), b3,
                )
                if dtype == torch.float32 and k1.shape[0] in KERNEL_C4:
                    w1, _, w2, _, w3, _ = out[f"{name}/fused"]
                    out[f"{name}/fused_tf32"] = tf32_split_weights(w1, w2, w3)
    if net.model == "facebook":
        k0 = net.adjust_dim[0].weight.detach().float()
        out["head0/kernel"] = k0.to(dtype).contiguous(memory_format=torch.channels_last)
        out["head0/bias"] = torch.zeros(k0.shape[0], dtype=torch.float32, device=k0.device)
        put("head", net.adjust_dim[1].weight, net.bn256)
    elif net.model != "resnet18":
        put("head", net.adjust_dim.weight, net.bn256)
    return out
