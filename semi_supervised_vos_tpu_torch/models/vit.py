"""DINO ViT-B/8 as the system's per-pixel embedder.

Caron et al., *Emerging Properties in Self-Supervised Vision Transformers*
(arXiv:2104.14294), ``vision_transformer.py::vit_base(patch_size=8)`` of
github.com/facebookresearch/dino, whose frozen patch features the paper
scores on DAVIS-2017 by label propagation:

  * a ``Conv2d(3, 768, 8, stride 8)`` patch embedding, a CLS token
    prepended and 1 + 28² learned position embeddings, the 28 × 28 grid
    interpolated bicubically to the frame's grid with the scale factors
    ((H/8 + 0.1)/28, (W/8 + 0.1)/28) (DINO's ``interpolate_pos_encoding``);
  * 12 pre-norm blocks, ``x = x + proj(attn(LN1(x)))`` then ``x = x +
    fc2(GELU(fc1(LN2(x))))``: LayerNorm eps 1e-6, ``qkv`` a
    ``Linear(768, 2304)`` with bias giving 12 heads of 64, scaled by 64^-0.5
    before a softmax over all tokens, MLP 768 → 3072 → 768, exact (erf)
    GELU;
  * the final LayerNorm; the feature of a pixel of the stride-8 grid is its
    patch token (CLS dropped, ``get_intermediate_layers(n=1)``), normalised
    to unit L2 norm as DINO's video-segmentation eval does (its 1/0.1
    similarity scale is the engine's ``temperature`` 10).

Frames whose sides are not multiples of 8 are padded on the bottom and
right with zeros after the ImageNet normalisation, so the grid is
``ceil(H/8) × ceil(W/8)``, as ``models/resnet.py::out_spatial`` gives for the
ResNets (DINO's own eval resizes 854 to 832 instead).

:class:`DinoViT` holds the parameters in float32 under the state-dict keys
of DINO's checkpoint (``cls_token``, ``pos_embed``, ``patch_embed.proj.*``,
``blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.fc1|mlp.fc2.*``, ``norm.*``).
Its ``forward`` is the float32 module (the CPU engine's path); its
:meth:`DinoViT.encode` is the card path, in bf16: the patch embedding, the
position table interpolated once per grid and cached, a float32 residual
stream, LayerNorm in float32 then rounded, the four products in bf16
(:func:`_linear`), ``F.scaled_dot_product_attention`` over the (N, 12, T,
64) heads (:func:`_sdpa`), the final LayerNorm and the L2 norm in float32,
then the features cast to the bank's dtype. While the recorder records
(``utils/profiling.py``) each frame's embedding is span ``vit.embed``, each
block's LN1-to-residual ``vit.attention`` and LN2-to-residual ``vit.mlp``
(each timed on the card), with counters ``vit.frames`` and ``vit.tokens``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from semi_supervised_vos_tpu_torch.utils import profiling
from semi_supervised_vos_tpu_torch.utils.profiling import span

# the published architecture of each ViT the port takes
VIT_ARCH = {"dino_vitb8": dict(patch=8, dim=768, depth=12, heads=12, hidden=3072, grid=28)}
LN_EPS = 1e-6


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """One of a block's four products (``qkv``, ``proj``, ``fc1``, ``fc2``)."""
    return F.linear(x, weight, bias)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over all tokens, (N, heads, T, 64) each, scaled by 64^-0.5."""
    return F.scaled_dot_product_attention(q, k, v)


def pad_to_patch(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, C, H, W) → zeros appended on the bottom and right up to multiples
    of ``patch``."""
    h, w = x.shape[-2:]
    return F.pad(x, (0, -w % patch, 0, -h % patch))


def interpolate_pos(pos_embed: torch.Tensor, hd: int, wd: int) -> torch.Tensor:
    """DINO's ``interpolate_pos_encoding``: the (1, 1 + G², C) table → (1, 1 +
    hd·wd, C) for an hd × wd grid, bicubic with scale factors ((hd + 0.1) /
    G, (wd + 0.1) / G); the table itself on the G × G grid."""
    g2 = pos_embed.shape[1] - 1
    g = int(math.sqrt(g2))
    if hd * wd == g2 and hd == wd:
        return pos_embed
    dim = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((hd + 0.1) / g, (wd + 0.1) / g), mode="bicubic")
    if grid.shape[-2:] != (hd, wd):
        raise ValueError(f"position grid {tuple(grid.shape[-2:])} is not the patch grid {(hd, wd)}")
    return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, hd * wd, dim)], dim=1)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, t, c = x.shape
        q, k, v = self.qkv(x).view(n, t, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, t, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class DinoViT(nn.Module):
    """(B, 3, H, W) normalised frames → (B, C, ceil(H/8), ceil(W/8))
    unit-norm patch features. ``model`` names the published architecture
    (:data:`VIT_ARCH`); keyword arguments override its numbers (the tests'
    small networks)."""

    card_path = True  # the engine runs encode() on the card

    def __init__(self, model: str = "dino_vitb8", **arch):
        super().__init__()
        if model not in VIT_ARCH:
            raise NotImplementedError(f"ViT {model!r} is not ported; one of {tuple(VIT_ARCH)}")
        a = dict(VIT_ARCH[model], **arch)
        self.model = model
        self.patch, self.feature_dim, self.heads = a["patch"], a["dim"], a["heads"]
        self.patch_embed = PatchEmbed(a["patch"], a["dim"])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, a["dim"]))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + a["grid"] ** 2, a["dim"]))
        self.blocks = nn.ModuleList([Block(a["dim"], a["heads"], a["hidden"]) for _ in range(a["depth"])])
        self.norm = nn.LayerNorm(a["dim"], eps=LN_EPS)
        self._card: Dict[tuple, object] = {}  # the card path's bf16 weights and position tables

    def load_state_dict(self, *args, **kwargs):
        self._card.clear()  # the card path's copies follow the new weights
        return super().load_state_dict(*args, **kwargs)

    def forward(self, x):
        x = pad_to_patch(x, self.patch)
        n = x.shape[0]
        hd, wd = x.shape[-2] // self.patch, x.shape[-1] // self.patch
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(n, -1, -1), t], dim=1) + interpolate_pos(self.pos_embed, hd, wd)
        for blk in self.blocks:
            t = blk(t)
        f = F.normalize(self.norm(t)[:, 1:], dim=-1)
        return f.transpose(1, 2).reshape(n, self.feature_dim, hd, wd)

    def _state(self, device) -> Dict[str, object]:
        """The card path's weights on ``device``: the four products' in bf16
        (biases float32), the rest float32; made once, as a fold would be."""
        key = ("weights", str(device))
        st = self._card.get(key)
        if st is None:
            bf = torch.bfloat16
            with torch.no_grad():
                st = {"patch_w": self.patch_embed.proj.weight.detach().to(device, bf),
                      "patch_b": self.patch_embed.proj.bias.detach().to(device, bf),
                      "cls": self.cls_token.detach().to(device, torch.float32)[0, 0],
                      "norm": (self.norm.weight.detach().to(device), self.norm.bias.detach().to(device)),
                      "blocks": [{
                          "n1": (b.norm1.weight.detach().to(device), b.norm1.bias.detach().to(device)),
                          "qkv": (b.attn.qkv.weight.detach().to(device, bf), b.attn.qkv.bias.detach().to(device, bf)),
                          "proj": (b.attn.proj.weight.detach().to(device, bf),
                                   b.attn.proj.bias.detach().to(device, bf)),
                          "n2": (b.norm2.weight.detach().to(device), b.norm2.bias.detach().to(device)),
                          "fc1": (b.mlp.fc1.weight.detach().to(device, bf), b.mlp.fc1.bias.detach().to(device, bf)),
                          "fc2": (b.mlp.fc2.weight.detach().to(device, bf), b.mlp.fc2.bias.detach().to(device, bf)),
                      } for b in self.blocks]}
            self._card[key] = st
        return st

    def _pos(self, hd: int, wd: int, device) -> torch.Tensor:
        """The (1 + hd·wd, C) float32 position table of an hd × wd grid with
        the CLS token's row holding the token itself, cached per grid."""
        key = ("pos", hd, wd, str(device))
        pos = self._card.get(key)
        if pos is None:
            with torch.no_grad():
                pos = interpolate_pos(self.pos_embed.detach().float(), hd, wd)[0].to(device).clone()
                pos[0] += self.cls_token.detach()[0, 0].to(device)
            self._card[key] = pos
        return pos

    @torch.no_grad()
    def encode(self, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """The card path: (N, H, W, 3) ImageNet-normalised float32 frames →
        (N, hd, wd, C) unit-norm features in ``dtype``."""
        dev = x.device
        st = self._state(dev)
        c, heads = self.feature_dim, self.heads
        with span("vit.embed", device=dev):
            xp = pad_to_patch(x.permute(0, 3, 1, 2), self.patch)
            n, hd, wd = xp.shape[0], xp.shape[-2] // self.patch, xp.shape[-1] // self.patch
            emb = F.conv2d(xp.to(torch.bfloat16), st["patch_w"], st["patch_b"], stride=self.patch)
            t = torch.empty((n, 1 + hd * wd, c), dtype=torch.float32, device=dev)
            t[:, 1:] = emb.flatten(2).transpose(1, 2)
            t[:, 0] = 0.0
            t += self._pos(hd, wd, dev)
        profiling.count("vit.frames", n)
        profiling.count("vit.tokens", n * t.shape[1])
        tokens = t.shape[1]
        for b in st["blocks"]:
            with span("vit.attention", device=dev):
                h = F.layer_norm(t, (c,), *b["n1"], LN_EPS).to(torch.bfloat16)
                q, k, v = _linear(h, *b["qkv"]).view(n, tokens, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
                o = _sdpa(q, k, v).transpose(1, 2).reshape(n, tokens, c)
                t += _linear(o, *b["proj"])
            with span("vit.mlp", device=dev):
                h = F.layer_norm(t, (c,), *b["n2"], LN_EPS).to(torch.bfloat16)
                t += _linear(F.gelu(_linear(h, *b["fc1"])), *b["fc2"])
        f = F.normalize(F.layer_norm(t[:, 1:], (c,), *st["norm"], LN_EPS), dim=-1)
        return f.to(dtype).view(n, hd, wd, c)

