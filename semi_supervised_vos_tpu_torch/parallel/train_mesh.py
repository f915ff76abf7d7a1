"""The train and eval steps over a mesh of devices: data parallelism with
BatchNorm over the global batch, ``--tp`` channel sharding, and both on a
2-D mesh. The port's counterpart of what the JAX package gets from pjit in
``train/loop.py``'s step (``cli/train.py:184-230``).

One process drives the whole ``(data, model)`` grid (``parallel/mesh.py``):
no process group, no threads, no module replicas. The forward walks
VOSNet's modules over a grid of activations:

  * data row r holds its slice of the batch (``mesh.shard_batch``) and,
    between layers, its full activation on each distinct device of the row;
  * a convolution computes, on device (r, m), output-channel slice m from
    row r's full input with column m's kernel shard (``--tp 1``: one
    column, the whole kernel);
  * a BatchNorm in training mode reduces each channel slice's statistics
    over every data row (``collectives.psum``), normalises with the global
    mean and biased variance, moves the running statistics once, flax-style
    (``models/resnet.py::BatchNorm2d``), and sends gradients through the
    global statistics (:class:`_GlobalBatchNorm`); every row sees the same
    statistics, as in the single-device step;
  * ``collectives.all_gather`` joins a row's channel slices before the next
    convolution.

Parameters exist once: replicated leaves are the network's own, on the
mesh's first device, split leaves one shard per ``model`` column
(``parallel/tp.py::shard_tp``). Each row reaches them through a
differentiable ``Tensor.to``, so their gradients sum over the rows into
the one copy and the optimizer steps once. The rows' embeddings are
gathered to the first device in batch order, where ``train/loop.py``'s
loss code (``make_head_fn``) sees exactly the global batch of the
single-device step, miners and their generator included.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from semi_supervised_vos_tpu_torch.config import DEFAULT
from semi_supervised_vos_tpu_torch.parallel import collectives
from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh, shard_batch
from semi_supervised_vos_tpu_torch.train.loop import features_from_embeddings, make_head_fn, normalized_frames

Acts = List[Dict[torch.device, torch.Tensor]]  # per data row: its full activation on each distinct device of the row


def _row_devices(row: Sequence[torch.device]) -> List[torch.device]:
    return list(dict.fromkeys(row))


def _acc(y: torch.Tensor) -> torch.Tensor:
    """``y`` at least in float32 (BatchNorm's arithmetic under autocast)."""
    return y.to(torch.promote_types(y.dtype, torch.float32))


class _GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm of one channel slice over every data row,
    with statistics computed beforehand (``stats``: the global mean and
    inverse standard deviation on each row's device, and the global count).
    Saves only the inputs; the backward is SyncBatchNorm's, with its two
    per-channel sums reduced over the rows."""

    @staticmethod
    def forward(ctx, stats, weight, bias, *ys):
        means, invstds, count = stats
        outs = []
        for y, mean, invstd in zip(ys, means, invstds):
            w, b = weight.to(y.device), bias.to(y.device)
            out = _acc(y) - mean[:, None, None]
            out.mul_((invstd * w)[:, None, None]).add_(b[:, None, None])
            outs.append(out.to(y.dtype))
        ctx.stats = stats
        ctx.save_for_backward(weight, *ys)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        weight, *ys = ctx.saved_tensors
        means, invstds, count = ctx.stats
        sum_dy, sum_dy_xmu = [], []
        for y, g, mean in zip(ys, grads, means):
            g = _acc(g)
            sum_dy.append(g.sum((0, 2, 3)))
            sum_dy_xmu.append((g * (_acc(y) - mean[:, None, None])).sum((0, 2, 3)))
        sum_dy, sum_dy_xmu = collectives.psum(sum_dy), collectives.psum(sum_dy_xmu)
        dxs = []
        for y, g, mean, invstd, sdy, sdx in zip(ys, grads, means, invstds, sum_dy, sum_dy_xmu):
            k = invstd * weight.to(y.device)
            dx = (_acc(y) - mean[:, None, None]).mul_((invstd * invstd * sdx / count)[:, None, None])
            dx = (_acc(g) - (sdy / count)[:, None, None]).sub_(dx).mul_(k[:, None, None])
            dxs.append(dx.to(y.dtype))
        grad_w = (sum_dy_xmu[0] * invstds[0]).to(weight.device) if ctx.needs_input_grad[1] else None
        grad_b = sum_dy[0].to(weight.device) if ctx.needs_input_grad[2] else None
        return (None, grad_w, grad_b, *dxs)


def _global_stats(ys: Sequence[torch.Tensor]):
    """Mean and biased variance of each channel over all rows' (N, C, H, W)
    slices, combined from the rows' own (Chan et al.), on each row's
    device; and the global count."""
    counts = [y.numel() // y.shape[1] for y in ys]
    total = sum(counts)
    local = [torch.var_mean(_acc(y), dim=(0, 2, 3), correction=0) for y in ys]
    means = collectives.psum([m * (n / total) for (_, m), n in zip(local, counts)])
    m2 = collectives.psum([(v + (m - g) ** 2) * (n / total) for (v, m), g, n in zip(local, means, counts)])
    return means, m2, total


class MeshNet:
    """A VOSNet laid out over a mesh, with its optimizer.

    ``tensors`` maps every parameter and buffer name of ``net`` to its
    shards, one per ``model`` column (a split leaf) or one (a replicated
    leaf: ``net``'s own tensor). Without ``tensors`` every leaf is
    replicated (data parallelism). When a leaf is split, ``optimizer`` is a
    new one of the same type and hyper-parameters over the shards, each
    with its slice of the momentum, and ``full_optimizer`` the one given,
    which :meth:`sync_to_net` keeps in the single-device layout that
    checkpoints use."""

    def __init__(self, mesh: Mesh, net: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                 tensors: Optional[Dict[str, List[torch.Tensor]]] = None):
        self.mesh, self.net = mesh, net
        own = net.state_dict(keep_vars=True)
        self.tensors = tensors if tensors is not None else {name: [t] for name, t in own.items()}
        self.full_optimizer = optimizer
        self.optimizer = optimizer
        self.split = {name for name, parts in self.tensors.items() if parts[0] is not own[name]}
        if self.split and optimizer is not None:
            self.optimizer = self._shard_optimizer(optimizer, own)
        self._names = {m: name for name, m in net.named_modules()}

    def _shard_optimizer(self, optimizer, own):
        if len(optimizer.param_groups) != 1:
            raise ValueError("a sharded optimizer takes one parameter group")
        group = optimizer.param_groups[0]
        hyper = {k: group[k] for k in ("lr", "momentum", "dampening", "weight_decay", "nesterov") if k in group}
        params = [part for name, p in own.items() if isinstance(p, nn.Parameter) for part in self.tensors[name]]
        sharded = type(optimizer)(params, **hyper)
        for name, p in own.items():
            if isinstance(p, nn.Parameter) and name not in self.split:
                sharded.state[p] = optimizer.state[p]  # one state for a replicated parameter
        for name in self.split:
            buf = optimizer.state.get(own[name], {}).get("momentum_buffer")
            if buf is not None:
                for part, piece in zip(self.tensors[name], buf.chunk(len(self.tensors[name]))):
                    sharded.state[part]["momentum_buffer"] = piece.to(part.device).clone()
        return sharded

    def on(self, mesh: Mesh) -> "MeshNet":
        """The same tensors and optimizer driven over another mesh with the
        same ``model`` columns (the train CLI's unsharded validation)."""
        if mesh.shape["model"] != self.mesh.shape["model"]:
            raise ValueError(f"{mesh} does not have the model columns of {self.mesh}")
        other = copy.copy(self)
        other.mesh = mesh
        return other

    @torch.no_grad()
    def sync_to_net(self) -> None:
        """Write the split leaves into ``net`` and their momenta into
        ``full_optimizer`` (a no-op without split leaves)."""
        own = self.net.state_dict(keep_vars=True)
        for name in self.split:
            parts = self.tensors[name]
            own[name].copy_(torch.cat([p.detach().to(own[name].device) for p in parts]))
            if self.full_optimizer is not None and self.optimizer is not None:
                bufs = [self.optimizer.state.get(p, {}).get("momentum_buffer") for p in parts]
                if all(b is not None for b in bufs):
                    self.full_optimizer.state[own[name]]["momentum_buffer"] = torch.cat(
                        [b.to(own[name].device) for b in bufs])

    # -- the forward over the grid -----------------------------------------

    def _conv(self, acts: Acts, conv: nn.Conv2d) -> List[List[torch.Tensor]]:
        """Per row, the output-channel slices of ``conv`` (one slice, the
        whole output, when its kernel is replicated)."""
        if conv.bias is not None or conv.groups != 1 or conv.dilation != (1, 1):
            raise NotImplementedError("the mesh step takes VOSNet's bias-free, ungrouped convolutions")
        shards = self.tensors[f"{self._names[conv]}.weight"]
        out = []
        for row, row_acts in zip(self.mesh.devices, acts):
            out.append([F.conv2d(row_acts[d], w.to(d), None, conv.stride, conv.padding)
                        for w, d in zip(shards, row)])
        return out

    def _batch_norm(self, parts: List[List[torch.Tensor]], bn: nn.BatchNorm2d) -> List[List[torch.Tensor]]:
        name = self._names[bn]
        shards = [self.tensors[f"{name}.{k}"] for k in ("weight", "bias", "running_mean", "running_var")]
        if len(shards[0]) != len(parts[0]):
            raise ValueError(f"{name}: {len(shards[0])} parameter shards for {len(parts[0])} channel slices")
        out = [[None] * len(p) for p in parts]
        for m, (w, b, rm, rv) in enumerate(zip(*shards)):
            ys = [p[m] for p in parts]
            if not self.net.training:
                for r, y in enumerate(ys):
                    d = y.device
                    out[r][m] = F.batch_norm(y, rm.to(d), rv.to(d), w.to(d), b.to(d), False, 0.0, bn.eps)
                continue
            with torch.no_grad():
                means, variances, count = _global_stats(ys)
                invstds = [torch.rsqrt(v + bn.eps) for v in variances]
                rm.mul_(1.0 - bn.momentum).add_(means[0].to(rm.device), alpha=bn.momentum)
                rv.mul_(1.0 - bn.momentum).add_(variances[0].to(rv.device), alpha=bn.momentum)
            for r, y in enumerate(_GlobalBatchNorm.apply((means, invstds, count), w, b, *ys)):
                out[r][m] = y
        if self.net.training:
            with torch.no_grad():
                self.tensors[f"{name}.num_batches_tracked"][0].add_(1)
        return out

    def _gather(self, parts: List[List[torch.Tensor]], relu: bool = False) -> Acts:
        """Each row's channel slices joined on each distinct device of the
        row (``collectives.all_gather`` along channels)."""
        acts = []
        for row, p in zip(self.mesh.devices, parts):
            if len(p) == 1:
                full = {d: p[0].to(d) for d in _row_devices(row)}
            else:
                full = dict(zip(row, collectives.all_gather(p, dim=1)))
            acts.append({d: F.relu(x, inplace=True) if relu else x for d, x in full.items()})
        return acts

    def _conv_bn(self, acts: Acts, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d], relu: bool = False) -> Acts:
        parts = self._conv(acts, conv)
        if bn is not None:
            parts = self._batch_norm(parts, bn)
        return self._gather(parts, relu)

    def _block(self, acts: Acts, block: nn.Module) -> Acts:
        """A BasicBlock or Bottleneck (``models/resnet.py``)."""
        residual = acts if block.downsample is None else self._conv_bn(acts, block.downsample[0], block.downsample[1])
        out = self._conv_bn(acts, block.conv1, block.bn1, relu=True)
        if hasattr(block, "conv3"):
            out = self._conv_bn(out, block.conv2, block.bn2, relu=True)
            out = self._conv_bn(out, block.conv3, block.bn3)
        else:
            out = self._conv_bn(out, block.conv2, block.bn2)
        return [{d: F.relu(x + res[d]) for d, x in o.items()} for o, res in zip(out, residual)]

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """VOSNet's forward on each data row's (N_r, 3, H, W) input (on the
        row's first device): the rows' (N_r, 256, H/8, W/8) embeddings, on
        the same devices, in the net's train or eval mode."""
        net = self.net
        acts = [{d: x.to(d) for d in _row_devices(row)} for x, row in zip(xs, self.mesh.devices)]
        conv1, bn1, _, pool, *layers = net.backbone
        acts = self._conv_bn(acts, conv1, bn1, relu=True)
        acts = [{d: F.max_pool2d(x, pool.kernel_size, pool.stride, pool.padding) for d, x in a.items()} for a in acts]
        for layer in layers:
            for block in layer:
                acts = self._block(acts, block)
        if hasattr(net, "adjust_dim"):
            convs = list(net.adjust_dim) if isinstance(net.adjust_dim, nn.Sequential) else [net.adjust_dim]
            for conv in convs[:-1]:
                acts = self._conv_bn(acts, conv, None)
            acts = self._conv_bn(acts, convs[-1], net.bn256)
        return [a[row[0]] for a, row in zip(acts, self.mesh.devices)]

    def clip_features(self, imgs: Sequence[torch.Tensor], bf16: bool = False) -> torch.Tensor:
        """Each row's (B_r, T, H, W, 3) uint8 clips → the global batch's
        (B, T, Hd, Wd, C) float32 features on the mesh's first device."""
        dev = self.mesh.devices[0][0]
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            outs = self.forward([normalized_frames(x) for x in imgs])
        shape = (sum(x.shape[0] for x in imgs), imgs[0].shape[1])
        return features_from_embeddings(torch.cat([o.to(dev) for o in outs]), *shape)


def _rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """A per-row list as staged, or one tensor cut over the data rows."""
    return list(x) if isinstance(x, (list, tuple)) else list(shard_batch(mesh, x)[0])


def make_mesh_train_step(mnet: MeshNet, spec, num_classes: int = DEFAULT.num_classes, bf16: bool = False):
    """``step(imgs, anns, centroids, generator, geometry=None) -> loss``, as
    ``train/loop.py::make_train_step`` but over ``mnet``'s mesh: ``imgs``
    and ``anns`` are lists of per-row tensors (``mesh.shard_batch``) or
    whole batches; centroids, geometry and the loss on the first device."""
    head = make_head_fn(spec, num_classes)

    def train_step(imgs, anns, centroids, generator, geometry=None):
        mnet.optimizer.zero_grad(set_to_none=True)
        dev = mnet.mesh.devices[0][0]
        feats = mnet.clip_features(_rows(mnet.mesh, imgs), bf16)
        anns = torch.cat([a.to(dev) for a in _rows(mnet.mesh, anns)])
        loss = head(feats, anns, centroids, generator, geometry)
        if loss.requires_grad:  # a frozen resnet18 has nothing to train
            loss.backward()
        mnet.optimizer.step()
        return loss.detach()

    return train_step


def make_mesh_eval_step(mnet: MeshNet, spec, num_classes: int = DEFAULT.num_classes, bf16: bool = False):
    """The eval step over ``mnet``'s mesh (running statistics, no update)."""
    head = make_head_fn(spec, num_classes)

    @torch.no_grad()
    def eval_step(imgs, anns, centroids, generator, geometry=None):
        dev = mnet.mesh.devices[0][0]
        feats = mnet.clip_features(_rows(mnet.mesh, imgs), bf16)
        anns = torch.cat([a.to(dev) for a in _rows(mnet.mesh, anns)])
        return head(feats, anns, centroids, generator, geometry)

    return eval_step
