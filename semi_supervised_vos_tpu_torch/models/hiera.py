"""SAM 2.1 Hiera-L as the system's per-pixel embedder.

Ravi et al., *SAM 2: Segment Anything in Images and Videos*
(arXiv:2408.00714), the image encoder of github.com/facebookresearch/sam2
(``configs/sam2.1/sam2.1_hiera_l.yaml``, ``modeling/backbones/hieradet.py``,
``image_encoder.py``, ``utils.py``):

  * a ``Conv2d(3, 144, 7, stride 4, padding 3)`` patch embedding, tokens
    laid out (N, H/4, W/4, 144), plus two position tables: ``pos_embed``
    (1, 144, 7, 7) resized bicubically to the stride-4 grid and
    ``pos_embed_window`` (1, 144, 8, 8) tiled over it;
  * 48 blocks in 4 stages of [2, 6, 36, 4], widths 144 / 288 / 576 / 1152,
    heads 2 / 4 / 8 / 16 (72 wide each), windows [8, 4, 16, 8] by stage,
    blocks 23, 33 and 43 global. The first block of stages 2–4 keeps the
    previous stage's window, max-pools its queries 2 × 2 inside each window
    and its shortcut ``MaxPool2d(2, 2)(Linear(dim, dim_out)(LN1(x)))``.
    Each block is ``x = shortcut + proj(attn(window_partition(LN1(x))))``
    then ``x = x + fc2(GELU(fc1(LN2(x))))``: LayerNorm eps 1e-6, ``qkv`` a
    ``Linear(dim, 3·dim_out)`` with bias, softmax scaled by 72^-0.5, exact
    GELU, MLP 4× wide. ``window_partition`` pads the grid's bottom and right
    with zeros, and the padded tokens enter every window's attention as keys
    (their keys and values are the ``qkv`` bias), unmasked;
  * the FPN neck's stride-16 level, which SAM 2 keeps in its memory:
    ``conv1x1(576 → 256)(stage 3) + nearest2×(conv1x1(1152 → 256)(stage
    4))``, the 2× upsampling in float32. The neck's stride-4 and stride-8
    levels feed only SAM 2's mask decoder and are not computed.

To meet the engine's stride-8 grid an (H, W) frame, ImageNet-normalised, is
upsampled 2× bicubically (align_corners False), zero-padded on the bottom
and right to multiples of :attr:`SamHiera.pad_multiple` (32 for Hiera-L: the
stride-4 grid then tiles the window table and the stride-32 grid is whole),
and the stride-16 level is cropped to ``out_spatial(H, W)`` and normalised
to unit L2 norm (SAM 2 resizes every frame to 1024² instead, and has no
label-propagation evaluation; temperature 10 as for DINO's features).

:class:`SamHiera` holds the parameters in float32 under SAM 2's keys with
``image_encoder.`` taken off (``trunk.patch_embed.proj.*``,
``trunk.pos_embed``, ``trunk.pos_embed_window``,
``trunk.blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.layers.{0,1}|proj.*``,
``neck.convs.{0,1}.conv.*``: the stage-4 and stage-3 laterals). Its
``forward`` is the float32 module (the CPU engine's path); its
:meth:`SamHiera.encode` the card path, in bf16: the upsampling in float32,
the embedding convolution in bf16, a float32 residual stream, LayerNorm in
float32 then rounded, every product (``qkv``, ``proj``, the transition
shortcuts, ``fc1``, ``fc2``, the two laterals as 1×1 products) in bf16
through ``models/vit.py::_linear``, attention through
``models/vit.py::_sdpa``: windows folded into the batch
(:func:`_window_attention`), global blocks over a frame's tokens
(:func:`_global_attention`); the neck sum and the L2 norm in float32, the
features cast to the bank's dtype.

While the recorder records (``utils/profiling.py``) each encode call's
upsampling, padding, embedding and position tables are span
``hiera.embed``; each windowed or transition block's LN1 to residual
``hiera.window_attention``, each global block's ``hiera.global_attention``,
each block's LN2 to residual ``hiera.mlp``, the neck ``hiera.neck`` (each
timed on the card), with counters ``hiera.frames``, ``hiera.tokens``
(stage-1 tokens after padding) and ``hiera.windows`` (windows attended,
summed over the blocks).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from semi_supervised_vos_tpu_torch.models import vit
from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
from semi_supervised_vos_tpu_torch.utils import profiling
from semi_supervised_vos_tpu_torch.utils.profiling import span

# the published architecture of each Hiera the port takes
HIERA_ARCH = {"sam2_hiera_l": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4), window_spec=(8, 4, 16, 8),
                                   global_att_blocks=(23, 33, 43), q_pool=3, bkg=(7, 7), d_model=256, mlp_ratio=4)}
LN_EPS = 1e-6
PATCH_STRIDE = 4


class BlockSpec(NamedTuple):
    dim: int
    dim_out: int
    heads: int
    window: int  # 0: global attention
    pool: bool  # a transition block: queries and shortcut max-pooled 2 × 2


def block_plan(a: dict) -> List[BlockSpec]:
    """Hiera's blocks as ``hieradet.py::Hiera.__init__`` lays them out: a
    transition block takes the next stage's width and heads but keeps the
    window of the stage before."""
    stage_ends = [sum(a["stages"][:i]) - 1 for i in range(1, len(a["stages"]) + 1)]
    pool_blocks = [e + 1 for e in stage_ends[:-1]][: a["q_pool"]]
    dim, heads, stage, out = a["embed_dim"], a["num_heads"], 0, []
    for i in range(sum(a["stages"])):
        window = 0 if i in a["global_att_blocks"] else a["window_spec"][stage]
        dim_out = dim
        if i - 1 in stage_ends:
            dim_out, heads, stage = 2 * dim, 2 * heads, stage + 1
        out.append(BlockSpec(dim, dim_out, heads, window, i in pool_blocks))
        dim = dim_out
    return out


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(2, 2)`` over (..., H, W, C), channels last (a last odd
    row or column dropped)."""
    h, w = x.shape[-3] // 2, x.shape[-2] // 2
    x = x[..., : 2 * h, : 2 * w, :]
    return x.unflatten(-3, (h, 2)).unflatten(-2, (w, 2)).amax(dim=(-4, -2))


def _tiles(g: torch.Tensor, x: torch.Tensor, s: int):
    """Pairs of matching views of a split padded grid ``g`` (N, nh, s, nw,
    s, C) and a grid ``x`` (N, H, W, C): the whole windows, and the part of
    the last row, the last column and the corner of windows that ``x``
    fills."""
    h, w = x.shape[1], x.shape[2]
    hf, wf = h // s, w // s
    rows = [((slice(0, hf), slice(None)), slice(0, hf * s), (hf, s))] if hf else []
    if h > hf * s:
        rows.append(((hf, slice(0, h - hf * s)), slice(hf * s, h), None))
    cols = [((slice(0, wf), slice(None)), slice(0, wf * s), (wf, s))] if wf else []
    if w > wf * s:
        cols.append(((wf, slice(0, w - wf * s)), slice(wf * s, w), None))
    for (gr, xr, rsplit) in rows:
        for (gc, xc, csplit) in cols:
            xp = x[:, xr, xc]
            if rsplit:
                xp = xp.unflatten(1, rsplit)
            if csplit:
                xp = xp.unflatten(-2, csplit)
            yield g[:, gr[0], gr[1], gc[0], gc[1]], xp


def window_partition(x: torch.Tensor, window: int, fill=0.0) -> torch.Tensor:
    """(N, H, W, C) → (N·nh·nw, window², C): the grid padded on the bottom
    and right to whole windows with ``fill`` (a number or a (C,) vector),
    each window's tokens in row-major order, the windows in row-major order
    of each frame (``utils.py::window_partition``'s layout); one pass over
    the grid."""
    n, h, w, c = x.shape
    nh, nw = -(-h // window), -(-w // window)
    out = x.new_empty((n, nh, nw, window, window, c))
    g = out.transpose(2, 3)
    if h % window:
        g[:, nh - 1, h % window:] = fill
    if w % window:
        g[:, :, :, nw - 1, w % window:] = fill
    for gp, xp in _tiles(g, x, window):
        gp.copy_(xp)
    return out.view(n * nh * nw, window * window, c)


def window_unpartition(x: torch.Tensor, n: int, grid, hw) -> torch.Tensor:
    """(N·nh·nw, s², C) windows of an nh × nw grid of s × s windows → the
    (N, H, W, C) grid, ``hw`` = (H, W), the padding left out; one pass."""
    nh, nw = grid
    s = math.isqrt(x.shape[1])
    g = x.view(n, nh, nw, s, s, x.shape[-1]).transpose(2, 3)
    out = x.new_empty((n, hw[0], hw[1], x.shape[-1]))
    for gp, xp in _tiles(g, out, s):
        xp.copy_(gp)
    return out


def _window_attention(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int, pool: bool) -> torch.Tensor:
    """Windowed attention over a block's (N, H, W, 3·C) ``qkv`` products:
    the grid split into windows folded into the batch and padded on the
    bottom and right to whole windows (a padded token's ``qkv`` is the
    product of LN1's zero, the ``bias``), the queries max-pooled 2 × 2 inside
    each window in a transition block, attention over each window's tokens,
    the windows put back → (N, H', W', C), H' = H // 2 where pooled."""
    n, h, w, c3 = qkv.shape
    c = c3 // 3
    grid = (-(-h // window), -(-w // window))
    profiling.count("hiera.windows", n * grid[0] * grid[1])
    q, k, v = window_partition(qkv, window, bias).view(-1, window * window, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    if pool:
        s = window // 2
        q = q.unflatten(2, (s, 2, s, 2)).amax(dim=(3, 5)).flatten(2, 3)
        h, w = h // 2, w // 2
    o = vit._sdpa(q, k, v).transpose(1, 2).reshape(q.shape[0], q.shape[2], c)
    return window_unpartition(o, n, grid, (h, w))


def _global_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A global block's attention over all of a frame's tokens, (N, heads,
    T, 72) each: a function of its own, apart from the windows' calls of
    ``vit._sdpa``, so that a trace can tell the two kinds apart."""
    return vit._sdpa(q, k, v)


def _attend(t: torch.Tensor, p: dict, spec: BlockSpec, dt: torch.dtype) -> torch.Tensor:
    """A block's LN1 to residual over the float32 (N, H, W, C) stream; the
    stream is updated in place, or a new one (a transition block) returned."""
    n, h, w, c = t.shape
    x = F.layer_norm(t, (c,), *p["n1"], LN_EPS).to(dt)
    qkv = vit._linear(x, *p["qkv"])
    if spec.window:
        o = _window_attention(qkv, p["qkv"][1], spec.heads, spec.window, spec.pool)
    else:
        q, k, v = qkv.view(n, h * w, 3, spec.heads, spec.dim_out // spec.heads).permute(2, 0, 3, 1, 4)
        o = _global_attention(q, k, v).transpose(1, 2).reshape(n, h, w, spec.dim_out)
    o = vit._linear(o, *p["proj"])
    if spec.pool:
        return _pool2(vit._linear(x, *p["short"])).float() + o
    t += o
    return t


def _mlp(t: torch.Tensor, p: dict, dt: torch.dtype) -> torch.Tensor:
    """A block's LN2 to residual, in place."""
    h = F.layer_norm(t, (t.shape[-1],), *p["n2"], LN_EPS).to(dt)
    t += vit._linear(F.gelu(vit._linear(h, *p["fc1"])), *p["fc2"])
    return t


class Attention(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim, hidden), nn.Linear(hidden, dim)])


class Block(nn.Module):
    def __init__(self, spec: BlockSpec, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(spec.dim, eps=LN_EPS)
        self.attn = Attention(spec.dim, spec.dim_out)
        self.norm2 = nn.LayerNorm(spec.dim_out, eps=LN_EPS)
        self.mlp = Mlp(spec.dim_out, mlp_ratio * spec.dim_out)
        if spec.dim != spec.dim_out:
            self.proj = nn.Linear(spec.dim, spec.dim_out)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=PATCH_STRIDE, padding=3)


class Trunk(nn.Module):
    def __init__(self, a: dict, plan: List[BlockSpec]):
        super().__init__()
        self.patch_embed = PatchEmbed(a["embed_dim"])
        self.pos_embed = nn.Parameter(torch.zeros(1, a["embed_dim"], *a["bkg"]))
        w0 = a["window_spec"][0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, a["embed_dim"], w0, w0))
        self.blocks = nn.ModuleList([Block(s, a["mlp_ratio"]) for s in plan])


class Lateral(nn.Module):
    def __init__(self, dim: int, d_model: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, d_model, 1)


class Neck(nn.Module):
    """The laterals of the stage-4 and stage-3 outputs (SAM 2's
    ``neck.convs.0`` and ``neck.convs.1``)."""

    def __init__(self, dims, d_model: int):
        super().__init__()
        self.convs = nn.ModuleList([Lateral(d, d_model) for d in dims])


class SamHiera(nn.Module):
    """(B, 3, H, W) normalised frames → (B, 256, ceil(H/8), ceil(W/8))
    unit-norm features of the neck's stride-16 level of the 2× upsampled
    frame. ``model`` names the published architecture (:data:`HIERA_ARCH`);
    keyword arguments override its numbers (the tests' small networks)."""

    card_path = True  # the engine runs encode() on the card

    def __init__(self, model: str = "sam2_hiera_l", **arch):
        super().__init__()
        if model not in HIERA_ARCH:
            raise NotImplementedError(f"Hiera {model!r} is not ported; one of {tuple(HIERA_ARCH)}")
        a = dict(HIERA_ARCH[model], **arch)
        if a["q_pool"] != len(a["stages"]) - 1:
            raise ValueError(f"the neck sums stage 4 upsampled 2x into stage 3: every stage after the first must "
                             f"pool (q_pool {len(a['stages']) - 1}, got {a['q_pool']})")
        self.model = model
        self.plan = block_plan(a)
        self.stage_ends = [sum(a["stages"][:i]) - 1 for i in range(1, len(a["stages"]) + 1)]
        self.feature_dim = a["d_model"]
        stride = PATCH_STRIDE * 2 ** a["q_pool"]
        w0 = PATCH_STRIDE * a["window_spec"][0]
        self.pad_multiple = stride * w0 // math.gcd(stride, w0)
        self.trunk = Trunk(a, self.plan)
        self.neck = Neck((self.plan[-1].dim_out, self.plan[self.stage_ends[2]].dim_out), a["d_model"])
        self._card: Dict[tuple, object] = {}  # the card path's bf16 weights and position tables

    def load_state_dict(self, *args, **kwargs):
        self._card.clear()  # the card path's copies follow the new weights
        return super().load_state_dict(*args, **kwargs)

    def frame_flops(self, h: int, w: int) -> float:
        """Multiply-adds × 2 of one (h, w) frame's encode, from its grids:
        the patch embedding; each block's products (``qkv`` and a
        transition's shortcut over its input grid, ``proj`` and the MLP over
        its output grid) and attention's two products (4·Lq·Lk·C a window,
        the padded keys included; 4·T²·C a global block); the two laterals
        over the stage-4 and stage-3 grids."""
        m = self.pad_multiple
        gh, gw = -(-2 * h // m) * m // PATCH_STRIDE, -(-2 * w // m) * m // PATCH_STRIDE
        total = 2.0 * gh * gw * self.trunk.patch_embed.proj.out_channels * 3 * 49
        grids = []
        for spec, b in zip(self.plan, self.trunk.blocks):
            t, c, co, hidden = gh * gw, spec.dim, spec.dim_out, b.mlp.layers[0].out_features
            if spec.window:
                ws = spec.window
                lq = (ws // 2) ** 2 if spec.pool else ws * ws
                total += 4.0 * -(-gh // ws) * -(-gw // ws) * lq * ws * ws * co
            else:
                total += 4.0 * t * t * co
            total += 2.0 * t * c * 3 * co
            if spec.pool:
                total += 2.0 * t * c * co
                gh, gw = gh // 2, gw // 2
            total += 2.0 * gh * gw * (co * co + 2 * co * hidden)
            grids.append(gh * gw * co)
        for i in (self.stage_ends[3], self.stage_ends[2]):
            total += 2.0 * grids[i] * self.feature_dim
        return total

    def _weights(self, device, dt: torch.dtype) -> Dict[str, object]:
        """The products' weights and biases in ``dt``, the rest float32."""

        def lin(m):
            return m.weight.to(device, dt), m.bias.to(device, dt)

        def ln(m):
            return m.weight.to(device, torch.float32), m.bias.to(device, torch.float32)

        def lateral(m):
            return m.conv.weight.flatten(1).to(device, dt), m.conv.bias.to(device, dt)

        blocks = []
        for b in self.trunk.blocks:
            p = {"n1": ln(b.norm1), "qkv": lin(b.attn.qkv), "proj": lin(b.attn.proj), "n2": ln(b.norm2),
                 "fc1": lin(b.mlp.layers[0]), "fc2": lin(b.mlp.layers[1])}
            if hasattr(b, "proj"):
                p["short"] = lin(b.proj)
            blocks.append(p)
        conv = self.trunk.patch_embed.proj
        return {"patch": (conv.weight.to(device, dt), conv.bias.to(device, dt)), "blocks": blocks,
                "neck4": lateral(self.neck.convs[0]), "neck3": lateral(self.neck.convs[1])}

    def _pos_table(self, h: int, w: int) -> torch.Tensor:
        """``Hiera._get_pos_embed`` for an h × w stride-4 grid, channels last:
        (1, h, w, C) float32."""
        tr = self.trunk
        pos = F.interpolate(tr.pos_embed.float(), size=(h, w), mode="bicubic", align_corners=False)
        win = tr.pos_embed_window.float()
        pos = pos + win.tile(1, 1, h // win.shape[-2], w // win.shape[-1])
        return pos.permute(0, 2, 3, 1)

    def _features(self, x: torch.Tensor, st: Dict[str, object], dt: torch.dtype, cached: bool) -> torch.Tensor:
        """(N, H, W, 3) normalised float32 frames → (N, hd, wd, 256) float32
        unit-norm features; products in ``dt``, the position table
        ``cached`` per grid (the card path) or made from the parameters."""
        dev = x.device
        n, h, w = x.shape[:3]
        with span("hiera.embed", device=dev):
            m = self.pad_multiple
            up = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bicubic", align_corners=False)
            up = F.pad(up, (0, -2 * w % m, 0, -2 * h % m))
            emb = F.conv2d(up.to(dt), *st["patch"], stride=PATCH_STRIDE, padding=3)
            g = tuple(emb.shape[-2:])
            t = emb.permute(0, 2, 3, 1).float().contiguous()
            t += self._pos(g, dev) if cached else self._pos_table(*g)
        profiling.count("hiera.frames", n)
        profiling.count("hiera.tokens", n * g[0] * g[1])
        for i, (spec, p) in enumerate(zip(self.plan, st["blocks"])):
            with span("hiera.window_attention" if spec.window else "hiera.global_attention", device=dev):
                t = _attend(t, p, spec, dt)
            with span("hiera.mlp", device=dev):
                t = _mlp(t, p, dt)
            if i == self.stage_ends[2]:
                stage3 = t
        with span("hiera.neck", device=dev):
            hd, wd = out_spatial(h, w)
            top = vit._linear(t.to(dt), *st["neck4"]).float()
            top = top[:, :, None, :, None].expand(-1, -1, 2, -1, 2, -1).flatten(3, 4).flatten(1, 2)
            f = vit._linear(stage3.to(dt), *st["neck3"]).float()[:, :hd, :wd] + top[:, :hd, :wd]
            return F.normalize(f, dim=-1)

    def forward(self, x):
        f = self._features(x.permute(0, 2, 3, 1), self._weights(x.device, torch.float32), torch.float32, False)
        return f.permute(0, 3, 1, 2)

    def _pos(self, g, device) -> torch.Tensor:
        """The card path's position table of a stride-4 grid, cached."""
        key = ("pos", g, str(device))
        pos = self._card.get(key)
        if pos is None:
            with torch.no_grad():
                pos = self._pos_table(*g).to(device).contiguous()
            self._card[key] = pos
        return pos

    @torch.no_grad()
    def encode(self, x: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
        """The card path: (N, H, W, 3) ImageNet-normalised float32 frames →
        (N, hd, wd, 256) unit-norm features in ``dtype``."""
        dev = x.device
        key = ("weights", str(dev))
        st = self._card.get(key)
        if st is None:
            st = self._card[key] = self._weights(dev, torch.bfloat16)
        return self._features(x, st, torch.bfloat16, True).to(dtype)
