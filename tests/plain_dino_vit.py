"""DINO's ViT forward in plain float32 PyTorch: the reference the port's
``models/vit.py`` is held to in the tests.

It follows ``vision_transformer.py`` of github.com/facebookresearch/dino
(``VisionTransformer.prepare_tokens``, ``interpolate_pos_encoding``,
``Block``, ``Attention``, ``Mlp``, ``get_intermediate_layers(n=1)``) written
out with explicit products: ``softmax(q kᵀ · d^-0.5) v``, ``F.layer_norm``
(eps 1e-6) and the exact ``F.gelu``, every product in float32 (TF32 off
while it runs). It imports nothing of the port and no JAX.

Departures from DINO's code, each the port's too:

* frames whose sides are not multiples of the patch are padded with zeros
  on the bottom and right (after the ImageNet normalisation), where DINO's
  video eval resizes them;
* the final LayerNorm is applied to the last block's tokens and the CLS
  token dropped, then every patch token normalised to unit L2 norm (DINO's
  ``eval_video_segmentation.py`` does this to the features it propagates);
* the output is (N, C, ceil(H/p), ceil(W/p)), channels first.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def seeded_state_dict(seed: int, dim: int = 64, depth: int = 2, hidden: int = 256, patch: int = 8,
                      grid: int = 28) -> Dict[str, torch.Tensor]:
    """A state dict under DINO's keys, drawn from ``seed``: linear and
    patch weights, CLS and position tables N(0, 0.05²), biases N(0, 0.02²),
    LayerNorm scales 1 + N(0, 0.1²) and shifts N(0, 0.02²) (random enough
    that every term of the forward matters)."""
    g = torch.Generator().manual_seed(seed)

    def n(*shape, std):
        return torch.randn(*shape, generator=g) * std

    sd = {"cls_token": n(1, 1, dim, std=0.05), "pos_embed": n(1, 1 + grid * grid, dim, std=0.05),
          "patch_embed.proj.weight": n(dim, 3, patch, patch, std=0.05), "patch_embed.proj.bias": n(dim, std=0.02)}
    for i in range(depth):
        b = f"blocks.{i}."
        for name, (o, k) in {"attn.qkv": (3 * dim, dim), "attn.proj": (dim, dim), "mlp.fc1": (hidden, dim),
                             "mlp.fc2": (dim, hidden)}.items():
            sd[b + name + ".weight"] = n(o, k, std=0.05 * math.sqrt(64 / k))
            sd[b + name + ".bias"] = n(o, std=0.02)
        for name in ("norm1", "norm2"):
            sd[b + name + ".weight"] = 1.0 + n(dim, std=0.1)
            sd[b + name + ".bias"] = n(dim, std=0.02)
    sd["norm.weight"] = 1.0 + n(dim, std=0.1)
    sd["norm.bias"] = n(dim, std=0.02)
    return sd


def interpolate_pos_encoding(pos_embed: torch.Tensor, h: int, w: int, patch: int) -> torch.Tensor:
    """DINO's, for a (padded) h x w frame: the table itself when the grid is
    the table's square grid, else the patch rows bicubically interpolated
    with scale factors ((h / p + 0.1) / G, (w / p + 0.1) / G)."""
    npatch = (h // patch) * (w // patch)
    n = pos_embed.shape[1] - 1
    if npatch == n and h == w:
        return pos_embed
    dim = pos_embed.shape[-1]
    g = int(math.sqrt(n))
    h0, w0 = h // patch + 0.1, w // patch + 0.1
    grid = F.interpolate(pos_embed[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2),
                         scale_factor=(h0 / g, w0 / g), mode="bicubic")
    assert int(h0) == grid.shape[-2] and int(w0) == grid.shape[-1]
    return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, heads: int, patch: int = 8) -> torch.Tensor:
    """(N, 3, H, W) ImageNet-normalised frames → (N, C, ceil(H/p), ceil(W/p))
    unit-norm patch features, in float32."""
    with no_tf32():
        x = x.float()
        x = F.pad(x, (0, -x.shape[-1] % patch, 0, -x.shape[-2] % patch))
        nb, _, h, w = x.shape
        t = F.conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"], stride=patch)
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([sd["cls_token"].expand(nb, -1, -1), t], dim=1)
        t = t + interpolate_pos_encoding(sd["pos_embed"], h, w, patch)
        dim = t.shape[-1]
        depth = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
        for i in range(depth):
            b = f"blocks.{i}."
            y = F.layer_norm(t, (dim,), sd[b + "norm1.weight"], sd[b + "norm1.bias"], EPS)
            qkv = y @ sd[b + "attn.qkv.weight"].T + sd[b + "attn.qkv.bias"]
            q, k, v = qkv.reshape(nb, -1, 3, heads, dim // heads).permute(2, 0, 3, 1, 4)
            attn = torch.softmax((q @ k.transpose(-2, -1)) * (dim // heads) ** -0.5, dim=-1)
            y = (attn @ v).transpose(1, 2).reshape(nb, -1, dim)
            t = t + y @ sd[b + "attn.proj.weight"].T + sd[b + "attn.proj.bias"]
            y = F.layer_norm(t, (dim,), sd[b + "norm2.weight"], sd[b + "norm2.bias"], EPS)
            y = F.gelu(y @ sd[b + "mlp.fc1.weight"].T + sd[b + "mlp.fc1.bias"])
            t = t + y @ sd[b + "mlp.fc2.weight"].T + sd[b + "mlp.fc2.bias"]
        t = F.layer_norm(t, (dim,), sd["norm.weight"], sd["norm.bias"], EPS)[:, 1:]
        t = t / t.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return t.transpose(1, 2).reshape(nb, dim, h // patch, w // patch)
