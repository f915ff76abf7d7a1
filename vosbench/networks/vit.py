"""The ViT family: DINO's Vision Transformer (Caron et al., arXiv:2104.14294;
``vision_transformer.py`` of github.com/facebookresearch/dino) as a
per-pixel embedder, each patch token of the last block a pixel of the
stride-``patch_size`` grid.

The architecture is read from the configuration's own keys:

* ``patch_size``: the patch embedding's kernel and stride, which is the
  ``output_stride``; ``embed_dim``: the token width, which is the
  ``feature_dim``; ``depth``: the pre-norm blocks; ``num_heads``: the
  attention heads (``embed_dim / num_heads`` wide); ``mlp_hidden``: the
  MLP's hidden width; ``pos_grid``: the side of the learned position table
  (1 + G² rows, interpolated to each frame's grid); ``ln_eps``: the
  LayerNorms' epsilon.

A frame's tokens are its patches (the frame padded with zeros on the bottom
and right to a multiple of the patch, after the normalisation) and a CLS
token; the feature of a pixel is its patch token after the final LayerNorm,
normalised to unit L2 norm as DINO's video-segmentation eval does.

The parameters are one flat dict under DINO's checkpoint keys
(``cls_token``, ``pos_embed``, ``patch_embed.proj.*``,
``blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.fc1|mlp.fc2.*``,
``norm.*``), so the same tensors load into the port's module. Weights are
drawn on the card from the seed as DINO initialises a ViT (``_init_weights``
and ``trunc_normal_(std=.02)``): every linear weight, the CLS token and the
position table N(0, 0.02²) (the ±2 truncation never bites at that
deviation), linear biases 0, LayerNorms 1 and 0, and the patch
convolution at PyTorch's default (weight and bias uniform in ±1 / √(3 p²)).
There is no BatchNorm and nothing to calibrate. The family runs inference
only: DINO's features are used frozen, and the reference trains ResNets.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vosbench.counts import PEAK_BF16_FLOPS, bound_s

KEYS = ("model", "patch_size", "embed_dim", "depth", "num_heads", "mlp_hidden", "pos_grid", "ln_eps", "feature_dim",
        "output_stride")
NO_TRAINING = "the vit family runs inference only: DINO's features are used frozen and the reference trains ResNets"
QUERY_BLOCK = 1024  # query rows of the plain attention at a time: a 480p frame's scores never live whole


def check(cfg: dict) -> None:
    """Raise ``ValueError`` naming each missing or inconsistent key."""
    missing = [k for k in KEYS if k not in cfg]
    if missing:
        raise ValueError(f"configuration {cfg.get('model')!r}: the vit family needs the key(s) {', '.join(missing)}")
    problems = []
    if cfg["feature_dim"] != cfg["embed_dim"]:
        problems.append(f"feature_dim {cfg['feature_dim']} is not embed_dim {cfg['embed_dim']}")
    if cfg["output_stride"] != cfg["patch_size"]:
        problems.append(f"output_stride {cfg['output_stride']} is not patch_size {cfg['patch_size']}")
    if cfg["embed_dim"] % cfg["num_heads"]:
        problems.append(f"embed_dim {cfg['embed_dim']} does not split into {cfg['num_heads']} heads")
    if problems:
        raise ValueError(f"configuration {cfg['model']!r}: " + "; ".join(problems))


def feature_hw(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The patch grid of an (h, w) frame, padded up to whole patches."""
    p = cfg["patch_size"]
    return -(-h // p), -(-w // p)


def linear_flops_per_token(cfg: dict) -> float:
    """A block's four products a token: qkv, proj, fc1, fc2."""
    c, hidden = cfg["embed_dim"], cfg["mlp_hidden"]
    return 2.0 * (c * 3 * c + c * c + 2 * c * hidden)


def frame_flops(cfg: dict, h: int, w: int) -> float:
    """The patch embedding, then per block its four products over the 1 +
    hd·wd tokens and attention's two products (q kᵀ and the weights times v,
    4·N²·C over the heads)."""
    hd, wd = feature_hw(cfg, h, w)
    n, c, p = 1 + hd * wd, cfg["embed_dim"], cfg["patch_size"]
    embed = 2.0 * hd * wd * c * 3 * p * p
    return embed + cfg["depth"] * (n * linear_flops_per_token(cfg) + 4.0 * n * n * c)


def train_forward_flops(cfg: dict, n: int, crop: int) -> float:
    raise NotImplementedError(NO_TRAINING)


def train_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    raise NotImplementedError(NO_TRAINING)


def parameter_keys(sd: Dict[str, torch.Tensor]) -> List[str]:
    raise NotImplementedError(NO_TRAINING)


def sdpa_call_bound(b: int, heads: int, n: int, kv: int, d: int) -> float:
    """Least seconds of one attention call over (b, heads, n, d) queries and
    (b, heads, kv, d) keys and values: its two products (4·b·heads·n·kv·d) at
    the bf16 rate, or its b·heads·n·kv exps on the MUFU pipe, or q, k, v and
    the output read or written once in bf16."""
    flops = 4.0 * b * heads * n * kv * d
    nbytes = 2.0 * b * heads * d * (2 * n + 2 * kv)
    return bound_s([(flops, PEAK_BF16_FLOPS)], nbytes, float(b * heads * n * kv))


def linear_call_bound(m: int, k: int, n: int) -> float:
    """Least seconds of one (m, k) x (k, n) bf16 product with its bias: its
    2·m·k·n operations at the bf16 rate, or the operands and the output
    once."""
    return bound_s([(2.0 * m * k * n, PEAK_BF16_FLOPS)], 2.0 * (m * k + k * n + m * n + n))


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Key → shape of every parameter, in DINO's order."""
    c, hidden, p, g = cfg["embed_dim"], cfg["mlp_hidden"], cfg["patch_size"], cfg["pos_grid"]
    out = {"cls_token": (1, 1, c), "pos_embed": (1, 1 + g * g, c), "patch_embed.proj.weight": (c, 3, p, p),
           "patch_embed.proj.bias": (c,)}
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (c,), b + "norm1.bias": (c,),
                    b + "attn.qkv.weight": (3 * c, c), b + "attn.qkv.bias": (3 * c,),
                    b + "attn.proj.weight": (c, c), b + "attn.proj.bias": (c,),
                    b + "norm2.weight": (c,), b + "norm2.bias": (c,),
                    b + "mlp.fc1.weight": (hidden, c), b + "mlp.fc1.bias": (hidden,),
                    b + "mlp.fc2.weight": (c, hidden), b + "mlp.fc2.bias": (c,)})
    out.update({"norm.weight": (c,), "norm.bias": (c,)})
    return out


def inference_weights(cfg: dict, seed: int, frames_u8: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """The weights from ``seed`` (DINO's initialisation; ``frames_u8`` is not
    read: nothing is calibrated), in two draws: one normal draw for the
    linear weights and the two tables, one uniform draw for the patch
    convolution."""
    g = torch.Generator(device=device).manual_seed(seed)
    shp = shapes(cfg)
    normal = [k for k in shp if k in ("cls_token", "pos_embed") or (k.startswith("blocks.") and k.endswith("weight")
                                                                      and ".norm" not in k)]
    sizes = [math.prod(shp[k]) for k in normal]
    flat = torch.randn(sum(sizes), generator=g, device=device) * 0.02
    sd: Dict[str, torch.Tensor] = {}
    drawn = dict(zip(normal, torch.split(flat, sizes)))
    p = cfg["patch_size"]
    bound = 1.0 / math.sqrt(3 * p * p)
    patch = (torch.rand(math.prod(shp["patch_embed.proj.weight"]) + cfg["embed_dim"], generator=g, device=device)
             * 2.0 - 1.0) * bound
    for k, s in shp.items():
        if k in drawn:
            sd[k] = drawn[k].view(s).clone()
        elif k == "patch_embed.proj.weight":
            sd[k] = patch[: math.prod(s)].view(s).clone()
        elif k == "patch_embed.proj.bias":
            sd[k] = patch[-cfg["embed_dim"]:].clone()
        elif k.endswith("weight"):  # LayerNorm scales
            sd[k] = torch.ones(s, device=device)
        else:
            sd[k] = torch.zeros(s, device=device)
    return sd


def pos_table(pos_embed: torch.Tensor, hd: int, wd: int) -> torch.Tensor:
    """DINO's ``interpolate_pos_encoding`` for an hd × wd grid: the table
    itself on its own square grid, else its patch rows resized bicubically
    with scale factors ((hd + 0.1) / G, (wd + 0.1) / G)."""
    n = pos_embed.shape[1] - 1
    if hd * wd == n and hd == wd:
        return pos_embed
    g, dim = int(math.sqrt(n)), pos_embed.shape[-1]
    grid = F.interpolate(pos_embed[:, 1:].reshape(1, g, g, dim).permute(0, 3, 1, 2),
                         scale_factor=((hd + 0.1) / g, (wd + 0.1) / g), mode="bicubic")
    return torch.cat([pos_embed[:, :1], grid.permute(0, 2, 3, 1).reshape(1, hd * wd, dim)], dim=1)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, bn=None,
            round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain reference: (N, 3, H, W) normalised frames → (N, embed_dim,
    hd, wd) unit-norm patch features, every product in float32 (call it
    inside ``float32_exact``), attention as explicit ``softmax(q kᵀ ·
    d^-0.5) v`` over blocks of query rows; ``round_to`` rounds every
    activation (the tokens, each LayerNorm's output, qkv, the heads' output,
    the MLP's hidden layer before and after the GELU, the residual stream
    after each add, the features) to a lower precision, the control's. ``bn``
    is not used: the family has no BatchNorm."""

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    p, c, heads, eps = cfg["patch_size"], cfg["embed_dim"], cfg["num_heads"], cfg["ln_eps"]
    dh = c // heads

    def ln(t, key):
        return F.layer_norm(t, (c,), sd[key + ".weight"], sd[key + ".bias"], eps)

    def lin(t, key):
        return t @ sd[key + ".weight"].T + sd[key + ".bias"]

    x = F.pad(x.float(), (0, -x.shape[-1] % p, 0, -x.shape[-2] % p))
    n, hd, wd = x.shape[0], x.shape[-2] // p, x.shape[-1] // p
    t = F.conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"], stride=p).flatten(2).transpose(1, 2)
    t = rnd(torch.cat([sd["cls_token"].expand(n, -1, -1), t], dim=1) + pos_table(sd["pos_embed"], hd, wd))
    tokens = t.shape[1]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        qkv = rnd(lin(rnd(ln(t, b + "norm1")), b + "attn.qkv"))
        q, k, v = qkv.view(n, tokens, 3, heads, dh).permute(2, 0, 3, 1, 4)
        o = torch.empty((n, heads, tokens, dh), device=x.device)
        for q0 in range(0, tokens, QUERY_BLOCK):
            a = torch.softmax((q[:, :, q0:q0 + QUERY_BLOCK] @ k.transpose(-2, -1)) * dh ** -0.5, dim=-1)
            o[:, :, q0:q0 + QUERY_BLOCK] = a @ v
        t = rnd(t + lin(rnd(o.transpose(1, 2).reshape(n, tokens, c)), b + "attn.proj"))
        hidden = rnd(F.gelu(rnd(lin(rnd(ln(t, b + "norm2")), b + "mlp.fc1"))))
        t = rnd(t + lin(hidden, b + "mlp.fc2"))
    f = ln(t[:, 1:], "norm")
    f = rnd(f / f.norm(dim=-1, keepdim=True).clamp(min=1e-12))
    return f.transpose(1, 2).reshape(n, c, hd, wd)


def program_net(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """The port's ViT with ``sd`` loaded, as the CLI builds it (its
    architecture from the configuration's keys)."""
    from semi_supervised_vos_tpu_torch.models.vit import DinoViT

    with torch.device("meta"):
        net = DinoViT(cfg["model"], patch=cfg["patch_size"], dim=cfg["embed_dim"], depth=cfg["depth"],
                      heads=cfg["num_heads"], hidden=cfg["mlp_hidden"], grid=cfg["pos_grid"])
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    return net


def wrap(tracer) -> None:
    """The encoder's own ranges (traced run): ``vosbench.vit.sdpa`` around
    each attention call and ``vosbench.vit.linear`` around each of the four
    products, with the shapes their rooflines count."""
    from semi_supervised_vos_tpu_torch.models import vit

    tracer.wrap(vit, "_sdpa", "vit.sdpa", lambda a, k: {
        "b": int(a[0].shape[0]), "heads": int(a[0].shape[1]), "n": int(a[0].shape[2]), "kv": int(a[1].shape[2]),
        "d": int(a[0].shape[3])})
    tracer.wrap(vit, "_linear", "vit.linear", lambda a, k: {
        "m": int(a[0].numel() // a[0].shape[-1]), "k": int(a[1].shape[1]), "n": int(a[1].shape[0])})
