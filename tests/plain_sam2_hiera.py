"""SAM 2.1 Hiera-L's image encoder in plain float32 PyTorch: the reference
the port's ``models/hiera.py`` is held to in the tests.

It follows github.com/facebookresearch/sam2 line by line:
``modeling/backbones/hieradet.py`` (``Hiera``, ``MultiScaleBlock``,
``MultiScaleAttention``, ``do_pool``), ``modeling/backbones/utils.py``
(``PatchEmbed``, ``window_partition``, ``window_unpartition``, written out
below), ``modeling/backbones/image_encoder.py`` (``FpnNeck``, ``ImageEncoder``
with ``scalp`` 1) and ``sam2_utils.py::MLP``, with the architecture of
``configs/sam2.1/sam2.1_hiera_l.yaml``. Attention is written out as
``softmax(q kᵀ · d^-0.5) v``, a global block's over blocks of query rows so
that a 480p frame's scores never live whole; LayerNorm eps 1e-6, exact
GELU, every product in float32 (TF32 off while it runs). It imports nothing
of the port and no JAX.

Departures from SAM 2's code, each the port's too (SAM 2 resizes every
frame to 1024 × 1024 and has no label-propagation evaluation):

* the ImageNet-normalised (H, W) frame is upsampled 2× bicubically
  (align_corners False);
* then zero-padded on the bottom and right to multiples of 32, so that the
  stride-4 grid tiles the 8 × 8 window table and the stride-32 grid is
  whole (the neck's 2× upsampling meets the stride-16 grid);
* the neck's stride-16 level (SAM 2's ``vision_features``) is cropped to the
  stride-8 grid of the original frame, ``ceil(H/8) × ceil(W/8)``;
* and normalised to unit L2 norm, as DINO's label-propagation evaluation
  does (the engine's temperature 10).

The neck's stride-4 and stride-8 levels, which feed only SAM 2's mask
decoder, and the position encodings of its outputs are not computed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6
QUERY_BLOCK = 1024
HIERA_L = dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4), window_spec=(8, 4, 16, 8),
               global_att_blocks=(23, 33, 43), q_pool=3, bkg=(7, 7), d_model=256)


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def blocks(arch: dict) -> List[dict]:
    """``Hiera.__init__``'s loop: each block's dim, dim_out, heads, window
    and whether it pools."""
    stages = arch["stages"]
    stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    q_pool_blocks = [x + 1 for x in stage_ends[:-1]][: arch["q_pool"]]
    embed_dim, num_heads, cur_stage, out = arch["embed_dim"], arch["num_heads"], 1, []
    for i in range(sum(stages)):
        dim_out = embed_dim
        window_size = arch["window_spec"][cur_stage - 1]
        window_size = 0 if i in arch["global_att_blocks"] else window_size
        if i - 1 in stage_ends:
            dim_out = int(embed_dim * 2.0)
            num_heads = int(num_heads * 2.0)
            cur_stage += 1
        out.append(dict(dim=embed_dim, dim_out=dim_out, heads=num_heads, window=window_size,
                        pool=i in q_pool_blocks))
        embed_dim = dim_out
    return out


def shapes(arch: dict) -> Dict[str, Tuple[int, ...]]:
    """Key → shape of every parameter the encoder's stride-16 level reads,
    under SAM 2's keys with ``image_encoder.`` taken off."""
    c0, w0 = arch["embed_dim"], arch["window_spec"][0]
    out = {"trunk.pos_embed": (1, c0) + tuple(arch["bkg"]), "trunk.pos_embed_window": (1, c0, w0, w0),
           "trunk.patch_embed.proj.weight": (c0, 3, 7, 7), "trunk.patch_embed.proj.bias": (c0,)}
    plan = blocks(arch)
    for i, b in enumerate(plan):
        k, d, do = f"trunk.blocks.{i}.", b["dim"], b["dim_out"]
        out.update({k + "norm1.weight": (d,), k + "norm1.bias": (d,),
                    k + "attn.qkv.weight": (3 * do, d), k + "attn.qkv.bias": (3 * do,),
                    k + "attn.proj.weight": (do, do), k + "attn.proj.bias": (do,),
                    k + "norm2.weight": (do,), k + "norm2.bias": (do,),
                    k + "mlp.layers.0.weight": (4 * do, do), k + "mlp.layers.0.bias": (4 * do,),
                    k + "mlp.layers.1.weight": (do, 4 * do), k + "mlp.layers.1.bias": (do,)})
        if d != do:
            out.update({k + "proj.weight": (do, d), k + "proj.bias": (do,)})
    stage_ends = [sum(arch["stages"][:i]) - 1 for i in range(1, len(arch["stages"]) + 1)]
    for j, s in enumerate((stage_ends[3], stage_ends[2])):
        out.update({f"neck.convs.{j}.conv.weight": (arch["d_model"], plan[s]["dim_out"], 1, 1),
                    f"neck.convs.{j}.conv.bias": (arch["d_model"],)})
    return out


def seeded_state_dict(seed: int, arch: dict) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights: linear weights and both position tables N(0,
    0.02²), LayerNorm scales near 1, every bias and LayerNorm shift small but
    not zero (so that the padded tokens' keys, the ``qkv`` bias, matter),
    the convolutions U(±1 / √fan_in)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, s in shapes(arch).items():
        if k.endswith("conv.weight") or k.endswith("patch_embed.proj.weight"):
            fan_in = math.prod(s[1:])
            sd[k] = (torch.rand(s, generator=g) * 2 - 1) / math.sqrt(fan_in)
        elif ".norm" in k and k.endswith("weight"):
            sd[k] = 1.0 + 0.1 * torch.randn(s, generator=g)
        elif k.endswith("bias"):
            sd[k] = 0.05 * torch.randn(s, generator=g)
        else:
            sd[k] = 0.02 * torch.randn(s, generator=g)
    return sd


def window_partition(x, window_size):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def do_pool(x):
    """``MaxPool2d(2, 2)`` on (B, H, W, C), through NCHW as SAM 2 does."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=2, stride=2).permute(0, 2, 3, 1)


def attention(q, k, v):
    """(B, heads, L, d) each → softmax(q kᵀ · d^-0.5) v, over blocks of query
    rows."""
    out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype, device=q.device)
    for q0 in range(0, q.shape[2], QUERY_BLOCK):
        a = torch.softmax((q[:, :, q0:q0 + QUERY_BLOCK] @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5, dim=-1)
        out[:, :, q0:q0 + QUERY_BLOCK] = a @ v
    return out


def linear(x, sd, key):
    return x @ sd[key + ".weight"].T + sd[key + ".bias"]


def multi_scale_attention(sd, k, b, x):
    B, H, W, _ = x.shape
    qkv = linear(x, sd, k + "attn.qkv").reshape(B, H * W, 3, b["heads"], -1)
    q, kk, v = torch.unbind(qkv, 2)
    if b["pool"]:
        q = do_pool(q.reshape(B, H, W, -1))
        H, W = q.shape[1:3]
        q = q.reshape(B, H * W, b["heads"], -1)
    x = attention(q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2))
    x = x.transpose(1, 2).reshape(B, H, W, -1)
    return linear(x, sd, k + "attn.proj")


def multi_scale_block(sd, i, b, x):
    k = f"trunk.blocks.{i}."
    shortcut = x
    x = F.layer_norm(x, (b["dim"],), sd[k + "norm1.weight"], sd[k + "norm1.bias"], EPS)
    if b["dim"] != b["dim_out"]:
        shortcut = do_pool(linear(x, sd, k + "proj")) if b["pool"] else linear(x, sd, k + "proj")
    window_size = b["window"]
    if window_size > 0:
        H, W = x.shape[1], x.shape[2]
        x, pad_hw = window_partition(x, window_size)
    x = multi_scale_attention(sd, k, b, x)
    if b["pool"]:
        window_size = b["window"] // 2
        H, W = shortcut.shape[1:3]
        pad_h = (window_size - H % window_size) % window_size
        pad_w = (window_size - W % window_size) % window_size
        pad_hw = (H + pad_h, W + pad_w)
    if b["window"] > 0:
        x = window_unpartition(x, window_size, pad_hw, (H, W))
    x = shortcut + x
    h = F.layer_norm(x, (b["dim_out"],), sd[k + "norm2.weight"], sd[k + "norm2.bias"], EPS)
    h = linear(F.gelu(linear(h, sd, k + "mlp.layers.0")), sd, k + "mlp.layers.1")
    return x + h


def trunk(sd, arch, x) -> List[torch.Tensor]:
    """``Hiera.forward``: (B, 3, H, W) → every stage's (B, C, H', W')."""
    x = F.conv2d(x, sd["trunk.patch_embed.proj.weight"], sd["trunk.patch_embed.proj.bias"], stride=4, padding=3)
    x = x.permute(0, 2, 3, 1)
    h, w = x.shape[1:3]
    window_embed = sd["trunk.pos_embed_window"]
    pos_embed = F.interpolate(sd["trunk.pos_embed"], size=(h, w), mode="bicubic")
    pos_embed = pos_embed + window_embed.tile([a // b for a, b in zip(pos_embed.shape, window_embed.shape)])
    x = x + pos_embed.permute(0, 2, 3, 1)
    stages = arch["stages"]
    stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    outputs = []
    for i, b in enumerate(blocks(arch)):
        x = multi_scale_block(sd, i, b, x)
        if i in stage_ends:
            outputs.append(x.permute(0, 3, 1, 2))
    return outputs


def neck_stride16(sd, xs) -> torch.Tensor:
    """``FpnNeck.forward`` with ``fpn_top_down_levels`` [2, 3], nearest
    interpolation and fuse "sum", as far as level 2 (stride 16), which
    ``ImageEncoder`` with ``scalp`` 1 gives as ``vision_features``."""
    n = len(xs) - 1
    prev_features = None
    for i in range(n, 1, -1):
        lateral = F.conv2d(xs[i], sd[f"neck.convs.{n - i}.conv.weight"], sd[f"neck.convs.{n - i}.conv.bias"])
        if prev_features is not None:
            top_down = F.interpolate(prev_features.to(dtype=torch.float32), scale_factor=2.0, mode="nearest",
                                     align_corners=None, antialias=False)
            prev_features = lateral + top_down
        else:
            prev_features = lateral
    return prev_features


def forward(sd: Dict[str, torch.Tensor], x: torch.Tensor, arch: dict = HIERA_L) -> torch.Tensor:
    """(N, 3, H, W) ImageNet-normalised frames → (N, d_model, ceil(H/8),
    ceil(W/8)) unit-norm features, TF32 off."""
    with no_tf32():
        h, w = x.shape[-2:]
        x = F.interpolate(x.float(), size=(2 * h, 2 * w), mode="bicubic", align_corners=False)
        x = F.pad(x, (0, -2 * w % 32, 0, -2 * h % 32))
        f = neck_stride16(sd, trunk(sd, arch, x))[:, :, : -(-h // 8), : -(-w // 8)]
        return f / f.norm(dim=1, keepdim=True).clamp(min=1e-12)
