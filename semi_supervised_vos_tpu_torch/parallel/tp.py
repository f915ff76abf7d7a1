"""Tensor parallelism: the backbone's channels sharded over the mesh's
``model`` axis, the PyTorch counterpart of
``semi_supervised_vos_tpu/parallel/tp.py``.

Every convolution kernel is split along its output channels and every
per-channel vector (BatchNorm weight, bias and running statistics, and the
SGD momentum of each) along the same axis, one shard per ``model`` column,
on that column's device. In the JAX package XLA's SPMD partitioner inserts
the collectives; here the mesh train step (``parallel/train_mesh.py``)
computes each column's channel slice and all-gathers the slices before the
next convolution. BatchNorm is per channel, so a channel shard normalises
its own slice; over the ``data`` axis it reduces its statistics across the
rows.

One shape rule covers the whole train state, as in the JAX package: in
this model family every 1-D leaf is a per-output-channel vector and every
4-D leaf a conv kernel with at least 64 output channels
(``tests/test_torch_train_mesh.py`` checks all four backbones).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh

SPLIT_4D = ("model", None, None, None)  # OIHW: output channels over "model"
SPLIT_1D = ("model",)
REPLICATED: Tuple = ()


def leaf_spec(shape, n_model: int) -> Tuple:
    """The sharding of one leaf, as a partition spec over its axes: a 4-D
    OIHW kernel whose output channels divide over ``n_model`` splits dim
    0; a 1-D vector of at least ``n_model`` entries that divide over it
    splits its only dim; everything else (scalars such as
    ``num_batches_tracked``) is replicated."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[0] % n_model == 0:
        return SPLIT_4D
    if len(shape) == 1 and shape[0] % n_model == 0 and shape[0] >= n_model:
        return SPLIT_1D
    return REPLICATED


def tp_shardings(mesh: Mesh, net: nn.Module) -> Dict[str, Tuple]:
    """Name → :func:`leaf_spec` for every parameter and buffer of ``net``."""
    n_model = mesh.shape["model"]
    return {name: leaf_spec(t.shape, n_model) for name, t in net.state_dict(keep_vars=True).items()}


def shard_tp(mesh: Mesh, net: nn.Module, optimizer: torch.optim.Optimizer):
    """``net`` and ``optimizer`` channel-sharded over ``model`` and
    replicated over ``data``: a :class:`~semi_supervised_vos_tpu_torch.
    parallel.train_mesh.MeshNet` whose split leaves are new tensors, shard
    m on ``mesh.devices[0][m]`` (its ``requires_grad`` as the leaf's), and
    whose optimizer, of ``optimizer``'s type and hyper-parameters, holds
    the shards with their slices of the momentum. Replicated leaves stay
    ``net``'s own. ``net`` and ``optimizer`` keep the single-device layout
    that checkpoints use: ``MeshNet.sync_to_net`` writes the shards back."""
    from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet

    n_model = mesh.shape["model"]
    specs = tp_shardings(mesh, net)
    columns = mesh.devices[0]
    tensors = {}
    with torch.no_grad():
        for name, t in net.state_dict(keep_vars=True).items():
            if specs[name] == REPLICATED or n_model == 1:
                tensors[name] = [t]
                continue
            parts = [c.to(d).clone() for c, d in zip(t.detach().chunk(n_model), columns)]
            if isinstance(t, nn.Parameter):
                parts = [nn.Parameter(p, requires_grad=t.requires_grad) for p in parts]
            tensors[name] = parts
    return MeshNet(mesh, net, optimizer, tensors=tensors)
