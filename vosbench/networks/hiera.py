"""The Hiera family: SAM 2's hierarchical image encoder (Ravi et al.,
arXiv:2408.00714; ``modeling/backbones/hieradet.py`` and
``image_encoder.py`` of github.com/facebookresearch/sam2) as a per-pixel
embedder, its FPN neck's stride-16 level of the 2× upsampled frame a pixel of
the frame's stride-8 grid.

The architecture is read from the configuration's own keys:

* ``embed_dim`` and ``num_heads``: stage 1's width and heads, each doubled
  at every later stage (``dim_mul`` and ``head_mul`` 2); ``stages``: the
  blocks a stage; ``window_spec``: each stage's window side;
  ``global_att_blocks``: the blocks that attend over the whole grid;
  ``q_pool``: the transitions (the first block of stages 2–4) that max-pool
  their queries and shortcut 2 × 2, keeping the window of the stage before;
  ``mlp_ratio``: the MLP's widening; ``pos_embed_bkg``: the side of the
  background position table resized to the stride-4 grid;
  ``pos_embed_window``: the side of the window table tiled over it;
  ``d_model``: the neck's width, which is the ``feature_dim``; ``ln_eps``;
  ``upsample`` and ``pad_multiple``: a frame is upsampled that many times
  (bicubic) and zero-padded on the bottom and right to that multiple, so that
  the stride-16 level is the stride-8 grid of the frame (``output_stride``).

A block is ``x = shortcut + proj(attn(window_partition(LN1(x))))`` then ``x
= x + fc2(GELU(fc1(LN2(x))))``; ``window_partition`` pads the grid with
zeros after LN1, so the padded tokens enter a window's attention as keys
whose ``qkv`` is its bias. The feature of a pixel is ``conv1x1(stage 3) +
nearest2×(conv1x1(stage 4))`` cropped to ``ceil(H/8) × ceil(W/8)`` and
normalised to unit L2 norm.

The parameters are one flat dict under SAM 2's checkpoint keys with
``image_encoder.`` taken off (``trunk.pos_embed``, ``trunk.pos_embed_window``,
``trunk.patch_embed.proj.*``,
``trunk.blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.layers.{0,1}|proj.*``,
``neck.convs.{0,1}.conv.*``: the stage-4 and stage-3 laterals; the neck's
stride-8 and stride-4 laterals feed only SAM 2's mask decoder), so the same
tensors load into the port's module. Weights are drawn on the card from the
seed: every linear weight and both position tables N(0, 0.02²), linear
biases 0, LayerNorms 1 and 0, the convolutions (the patch embedding and the
laterals) at PyTorch's default (weight and bias uniform in ±1 / √fan_in).
There is no BatchNorm and nothing to calibrate. The family runs inference
only: SAM 2's encoder is used frozen, and the reference trains ResNets.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vosbench.networks.vit import sdpa_call_bound

KEYS = ("model", "embed_dim", "num_heads", "stages", "window_spec", "global_att_blocks", "q_pool", "mlp_ratio",
        "pos_embed_bkg", "pos_embed_window", "d_model", "ln_eps", "upsample", "pad_multiple", "feature_dim",
        "output_stride")
NO_TRAINING = "the hiera family runs inference only: SAM 2's encoder is used frozen and the reference trains ResNets"
QUERY_BLOCK = 1024  # query rows of a global block's plain attention at a time
PATCH = 4  # the patch embedding's stride (kernel 7, padding 3)


def check(cfg: dict) -> None:
    """Raise ``ValueError`` naming each missing or inconsistent key."""
    missing = [k for k in KEYS if k not in cfg]
    if missing:
        raise ValueError(f"configuration {cfg.get('model')!r}: the hiera family needs the key(s) {', '.join(missing)}")
    problems = []
    n = len(cfg["stages"])
    if cfg["feature_dim"] != cfg["d_model"]:
        problems.append(f"feature_dim {cfg['feature_dim']} is not d_model {cfg['d_model']}")
    if cfg["output_stride"] * cfg["upsample"] != 16:
        problems.append(f"output_stride {cfg['output_stride']} x upsample {cfg['upsample']} is not the neck's 16")
    if len(cfg["window_spec"]) != n or cfg["q_pool"] != n - 1 or n != 4:
        problems.append(f"the neck needs 4 stages, each after the first pooling, with a window each (stages "
                        f"{cfg['stages']}, window_spec {cfg['window_spec']}, q_pool {cfg['q_pool']})")
    elif cfg["pos_embed_window"] != cfg["window_spec"][0]:
        problems.append(f"pos_embed_window {cfg['pos_embed_window']} is not stage 1's window {cfg['window_spec'][0]}")
    elif cfg["pad_multiple"] % (PATCH * 2 ** cfg["q_pool"]) or cfg["pad_multiple"] % (PATCH * cfg["window_spec"][0]):
        problems.append(f"pad_multiple {cfg['pad_multiple']} does not make the stride-32 grid whole and the stride-4 "
                        f"grid a whole number of windows")
    if cfg["embed_dim"] % cfg["num_heads"]:
        problems.append(f"embed_dim {cfg['embed_dim']} does not split into {cfg['num_heads']} heads")
    if problems:
        raise ValueError(f"configuration {cfg['model']!r}: " + "; ".join(problems))


def feature_hw(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The stride-8 grid of an (h, w) frame."""
    s = cfg["output_stride"]
    return -(-h // s), -(-w // s)


def blocks(cfg: dict) -> List[dict]:
    """Each block's dim, dim_out, heads, window (0: global) and whether it
    pools, as ``Hiera.__init__`` lays them out."""
    stages = cfg["stages"]
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    pools = [e + 1 for e in ends[:-1]][: cfg["q_pool"]]
    dim, heads, stage, out = cfg["embed_dim"], cfg["num_heads"], 0, []
    for i in range(sum(stages)):
        window = 0 if i in cfg["global_att_blocks"] else cfg["window_spec"][stage]
        dim_out = dim
        if i - 1 in ends:
            dim_out, heads, stage = 2 * dim, 2 * heads, stage + 1
        out.append(dict(dim=dim, dim_out=dim_out, heads=heads, window=window, pool=i in pools))
        dim = dim_out
    return out


def stage_ends(cfg: dict) -> List[int]:
    return [sum(cfg["stages"][:i]) - 1 for i in range(1, len(cfg["stages"]) + 1)]


def stride4_grid(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The stride-4 grid of an (h, w) frame, upsampled and padded."""
    m, u = cfg["pad_multiple"], cfg["upsample"]
    return -(-u * h // m) * m // PATCH, -(-u * w // m) * m // PATCH


def window_attention_call_bound(b: int, heads: int, n: int, kv: int, d: int) -> float:
    """Least seconds of the attention in one windowed or transition call
    over b windows, (b, heads, n, d) queries (n = window² / 4 where pooled)
    and (b, heads, kv, d) keys and values: its two products at the bf16 rate,
    its exps on the MUFU pipe, or q, k, v and the output once in bf16
    (``networks/vit.py::sdpa_call_bound``). The call's partition, padding,
    pooling and unpartition copies are not in it."""
    return sdpa_call_bound(b, heads, n, kv, d)


def frame_flops(cfg: dict, h: int, w: int) -> float:
    """The patch embedding; per block its products (``qkv`` over the grid,
    the transition's shortcut, ``proj``, ``fc1`` and ``fc2`` over its output
    grid) and attention's two products (4·Lq·Lk·C a window, padded keys
    included; 4·T²·C a global block); the two laterals of the neck over the
    stage-3 and stage-4 grids."""
    gh, gw = stride4_grid(cfg, h, w)
    c0 = cfg["embed_dim"]
    total = 2.0 * gh * gw * c0 * 3 * 49
    grids = []
    for b in blocks(cfg):
        t = gh * gw
        ho, wo = (gh // 2, gw // 2) if b["pool"] else (gh, gw)
        to, c, co = ho * wo, b["dim"], b["dim_out"]
        total += 2.0 * t * c * 3 * co + 2.0 * to * co * co + 2.0 * 2 * to * co * cfg["mlp_ratio"] * co
        if b["pool"]:
            total += 2.0 * t * c * co
        if b["window"]:
            ws = b["window"]
            windows = -(-gh // ws) * -(-gw // ws)
            lq = (ws // 2) ** 2 if b["pool"] else ws * ws
            total += 4.0 * windows * lq * ws * ws * co
        else:
            total += 4.0 * t * t * co
        gh, gw = ho, wo
        grids.append((gh, gw, co))
    ends = stage_ends(cfg)
    for s in (ends[2], ends[3]):
        gh, gw, c = grids[s]
        total += 2.0 * gh * gw * c * cfg["d_model"]
    return total


def train_forward_flops(cfg: dict, n: int, crop: int) -> float:
    raise NotImplementedError(NO_TRAINING)


def train_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    raise NotImplementedError(NO_TRAINING)


def parameter_keys(sd: Dict[str, torch.Tensor]) -> List[str]:
    raise NotImplementedError(NO_TRAINING)


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Key → shape of every parameter, in SAM 2's order."""
    c0, w0, bkg = cfg["embed_dim"], cfg["pos_embed_window"], cfg["pos_embed_bkg"]
    out = {"trunk.pos_embed": (1, c0, bkg, bkg), "trunk.pos_embed_window": (1, c0, w0, w0),
           "trunk.patch_embed.proj.weight": (c0, 3, 7, 7), "trunk.patch_embed.proj.bias": (c0,)}
    plan = blocks(cfg)
    for i, b in enumerate(plan):
        k, d, do, hid = f"trunk.blocks.{i}.", b["dim"], b["dim_out"], cfg["mlp_ratio"] * b["dim_out"]
        out.update({k + "norm1.weight": (d,), k + "norm1.bias": (d,),
                    k + "attn.qkv.weight": (3 * do, d), k + "attn.qkv.bias": (3 * do,),
                    k + "attn.proj.weight": (do, do), k + "attn.proj.bias": (do,),
                    k + "norm2.weight": (do,), k + "norm2.bias": (do,),
                    k + "mlp.layers.0.weight": (hid, do), k + "mlp.layers.0.bias": (hid,),
                    k + "mlp.layers.1.weight": (do, hid), k + "mlp.layers.1.bias": (do,)})
        if d != do:
            out.update({k + "proj.weight": (do, d), k + "proj.bias": (do,)})
    ends = stage_ends(cfg)
    for j, s in enumerate((ends[3], ends[2])):
        out.update({f"neck.convs.{j}.conv.weight": (cfg["d_model"], plan[s]["dim_out"], 1, 1),
                    f"neck.convs.{j}.conv.bias": (cfg["d_model"],)})
    return out


def inference_weights(cfg: dict, seed: int, frames_u8: torch.Tensor, device) -> Dict[str, torch.Tensor]:
    """The weights from ``seed`` (``frames_u8`` is not read: nothing is
    calibrated), in two draws: one normal draw for the linear weights and the
    two position tables, one uniform draw for the convolutions."""
    g = torch.Generator(device=device).manual_seed(seed)
    shp = shapes(cfg)
    convs = [k for k in shp if k.startswith("trunk.patch_embed.") or k.startswith("neck.")]
    normal = [k for k in shp if k in ("trunk.pos_embed", "trunk.pos_embed_window")
              or (k.startswith("trunk.blocks.") and k.endswith("weight") and ".norm" not in k)]
    sizes = [math.prod(shp[k]) for k in normal]
    drawn = dict(zip(normal, torch.split(torch.randn(sum(sizes), generator=g, device=device) * 0.02, sizes)))
    sizes = [math.prod(shp[k]) for k in convs]
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0
    for k, v in zip(convs, torch.split(flat, sizes)):
        w = shp[k.rsplit(".", 1)[0] + ".weight"]
        drawn[k] = v / math.sqrt(math.prod(w[1:]))
    sd: Dict[str, torch.Tensor] = {}
    for k, s in shp.items():
        if k in drawn:
            sd[k] = drawn[k].view(s).clone()
        elif k.endswith("weight"):  # LayerNorm scales
            sd[k] = torch.ones(s, device=device)
        else:
            sd[k] = torch.zeros(s, device=device)
    return sd


def _window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) → (B·nh·nw, ws, ws, C) windows of the grid padded with
    zeros on the bottom and right, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, -w % ws, 0, -h % ws))
    hp, wp = x.shape[1:3]
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def _window_unpartition(x: torch.Tensor, ws: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    b = x.shape[0] // (hp * wp // ws // ws)
    x = x.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, : hw[0], : hw[1]]


def _pool(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(2, 2)`` over (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, bn=None,
            round_to: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain reference: (N, 3, H, W) normalised frames → (N, d_model, hd,
    wd) unit-norm features, every product in float32 (call it inside
    ``float32_exact``), attention as explicit ``softmax(q kᵀ · d^-0.5) v``
    (a global block's over blocks of query rows); ``round_to`` rounds every
    activation (the tokens, each LayerNorm's output, qkv, the heads' output,
    the transitions' shortcut, the MLP's hidden layer before and after the
    GELU, the residual stream after each add, the laterals, the features) to
    a lower precision, the control's. ``bn`` is not used: the family has no
    BatchNorm."""

    def rnd(t):
        return t if round_to is None else t.to(round_to).float()

    eps, u, m = cfg["ln_eps"], cfg["upsample"], cfg["pad_multiple"]

    def lin(t, key):
        return t @ sd[key + ".weight"].T + sd[key + ".bias"]

    def attend(q, k, v):
        out = torch.empty(q.shape[:-1] + (v.shape[-1],), device=q.device)
        for q0 in range(0, q.shape[2], QUERY_BLOCK):
            a = torch.softmax((q[:, :, q0:q0 + QUERY_BLOCK] @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5, dim=-1)
            out[:, :, q0:q0 + QUERY_BLOCK] = a @ v
        return out

    h, w = x.shape[-2:]
    x = F.interpolate(x.float(), size=(u * h, u * w), mode="bicubic", align_corners=False)
    x = F.pad(x, (0, -u * w % m, 0, -u * h % m))
    t = F.conv2d(x, sd["trunk.patch_embed.proj.weight"], sd["trunk.patch_embed.proj.bias"], stride=PATCH, padding=3)
    gh, gw = t.shape[-2:]
    pos = F.interpolate(sd["trunk.pos_embed"], size=(gh, gw), mode="bicubic", align_corners=False)
    win = sd["trunk.pos_embed_window"]
    pos = pos + win.tile(1, 1, gh // win.shape[-2], gw // win.shape[-1])
    t = rnd((t + pos).permute(0, 2, 3, 1))
    outs = []
    ends = stage_ends(cfg)
    for i, b in enumerate(blocks(cfg)):
        k = f"trunk.blocks.{i}."
        heads, do = b["heads"], b["dim_out"]
        hn = rnd(F.layer_norm(t, (b["dim"],), sd[k + "norm1.weight"], sd[k + "norm1.bias"], eps))
        shortcut = rnd(_pool(lin(hn, k + "proj"))) if b["pool"] else t
        gh, gw = hn.shape[1:3]
        xw = hn
        if b["window"]:
            xw, pad_hw = _window_partition(hn, b["window"])
        nb, wh, ww = xw.shape[:3]
        qkv = rnd(lin(xw, k + "attn.qkv")).reshape(nb, wh * ww, 3, heads, do // heads)
        q, kk, v = torch.unbind(qkv, 2)
        if b["pool"]:
            q = _pool(q.reshape(nb, wh, ww, do))
            wh, ww = q.shape[1:3]
            q = q.reshape(nb, wh * ww, heads, do // heads)
        o = rnd(attend(q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2))
        o = o.reshape(nb, wh, ww, do)
        if b["window"]:
            ws = b["window"] // 2 if b["pool"] else b["window"]
            ho, wo = shortcut.shape[1:3]
            o = _window_unpartition(o, ws, (-(-ho // ws) * ws, -(-wo // ws) * ws), (ho, wo))
        t = rnd(shortcut + lin(o, k + "attn.proj"))
        hn = rnd(F.layer_norm(t, (do,), sd[k + "norm2.weight"], sd[k + "norm2.bias"], eps))
        hidden = rnd(F.gelu(rnd(lin(hn, k + "mlp.layers.0"))))
        t = rnd(t + lin(hidden, k + "mlp.layers.1"))
        if i in ends:
            outs.append(t)
    lateral3, lateral4 = (rnd(F.conv2d(outs[s].permute(0, 3, 1, 2), sd[f"neck.convs.{j}.conv.weight"],
                                       sd[f"neck.convs.{j}.conv.bias"])) for s, j in ((2, 1), (3, 0)))
    hd, wd = feature_hw(cfg, h, w)
    f = (lateral3 + F.interpolate(lateral4, scale_factor=2.0, mode="nearest"))[:, :, :hd, :wd]
    return rnd(f / f.norm(dim=1, keepdim=True).clamp(min=1e-12))


def program_net(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """The port's Hiera with ``sd`` loaded, as the CLI builds it (its
    architecture from the configuration's keys)."""
    from semi_supervised_vos_tpu_torch.models.hiera import SamHiera

    with torch.device("meta"):
        net = SamHiera(cfg["model"], embed_dim=cfg["embed_dim"], num_heads=cfg["num_heads"],
                       stages=tuple(cfg["stages"]), window_spec=tuple(cfg["window_spec"]),
                       global_att_blocks=tuple(cfg["global_att_blocks"]), q_pool=cfg["q_pool"],
                       bkg=(cfg["pos_embed_bkg"],) * 2, d_model=cfg["d_model"], mlp_ratio=cfg["mlp_ratio"])
    if net.pad_multiple != cfg["pad_multiple"]:
        raise ValueError(f"the port pads to {net.pad_multiple}, the configuration to {cfg['pad_multiple']}")
    net = net.to_empty(device=device)
    net.load_state_dict(sd)
    return net


def wrap(tracer) -> None:
    """The encoder's own ranges (traced run): ``vosbench.hiera.window``
    around each windowed or transition block's attention (partition, pool,
    attention, unpartition), ``vosbench.vit.sdpa`` around each global
    block's attention call and ``vosbench.vit.linear`` around each product,
    with the shapes their rooflines count."""
    from semi_supervised_vos_tpu_torch.models import hiera, vit

    def window(a, k):
        qkv, heads, ws, pool = a[0], a[2], a[3], a[4]
        n, h, w, c3 = qkv.shape
        lq = (ws // 2) ** 2 if pool else ws * ws
        return {"b": int(n * -(-h // ws) * -(-w // ws)), "heads": int(heads), "n": int(lq), "kv": int(ws * ws),
                "d": int(c3 // 3 // heads)}

    tracer.wrap(hiera, "_window_attention", "hiera.window", window)
    tracer.wrap(hiera, "_global_attention", "vit.sdpa", lambda a, k: {
        "b": int(a[0].shape[0]), "heads": int(a[0].shape[1]), "n": int(a[0].shape[2]), "kv": int(a[1].shape[2]),
        "d": int(a[0].shape[3])})
    tracer.wrap(vit, "_linear", "vit.linear", lambda a, k: {
        "m": int(a[0].numel() // a[0].shape[-1]), "k": int(a[1].shape[1]), "n": int(a[1].shape[0])})
