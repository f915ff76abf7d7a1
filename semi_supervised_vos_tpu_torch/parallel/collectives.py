"""Collectives over the shards of one mesh axis: the PyTorch counterpart of
``semi_supervised_vos_tpu/parallel/collectives.py``.

In the JAX package each function runs inside a ``shard_map`` body and sees
this device's shard. Here one process drives every shard, so each function
takes the list of per-shard tensors along one axis (shard i on its own
device) and returns a list of the same length, result i on shard i's
device. Reductions run on the first shard's device, in shard order, and
the result is copied back to each shard's device (a shard on the first
device gets the result itself, not a copy).

Ordering: ``Tensor.to(device)`` between two CUDA devices waits for the
source device's current stream and runs on the destination's, and the
kernels launch on the current streams, so a reduction on the first device
sees every shard's finished result.

The mesh train step (``parallel/train_mesh.py``) reduces BatchNorm's
statistics and their gradients' sums over the data rows with :func:`psum`
and joins a row's channel slices with :func:`all_gather`; the bank-sharded
engines combine their shards' statistics with
``parallel/sharded_affinity.py::distributed_softmax_combine``.
``shard_mapped`` has no counterpart: the callers loop over their shards.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def _reduce(xs: Sequence[torch.Tensor], op) -> torch.Tensor:
    dev = xs[0].device
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(dev))
    return out


def _broadcast(x: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [x.to(s.device) for s in like]


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce sum."""
    return _broadcast(_reduce(xs, torch.add), xs)


def pmean(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce mean."""
    return _broadcast(_reduce(xs, torch.add) / len(xs), xs)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-reduce max (the online softmax's global max)."""
    return _broadcast(_reduce(xs, torch.maximum), xs)


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
    """Every shard gets all shards concatenated along ``dim``, in shard
    order (JAX's ``all_gather(..., axis=dim, tiled=True)``)."""
    dev = xs[0].device
    return _broadcast(torch.cat([x.to(dev) for x in xs], dim=dim), xs)


def ppermute_shift(xs: Sequence[torch.Tensor], shift: int = 1) -> List[torch.Tensor]:
    """Rotate the shards around the ring: shard i's tensor goes to shard
    (i + shift) mod n."""
    n = len(xs)
    return [xs[(i - shift) % n].to(xs[i].device) for i in range(n)]


def reduce_scatter(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum, then shard i keeps the i-th of n equal blocks of dim 0."""
    total = _reduce(xs, torch.add)
    return [blk.to(x.device) for blk, x in zip(total.chunk(len(xs)), xs)]


def ring_all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`all_gather` as n − 1 ring rotations (:func:`ppermute_shift`),
    the form an inter-device copy kernel would issue; bitwise equal to
    :func:`all_gather`."""
    n = len(xs)
    rows = xs[0].shape[0]
    outs = [x.new_zeros((n * rows,) + tuple(x.shape[1:])) for x in xs]
    for i, (out, x) in enumerate(zip(outs, xs)):
        out[i * rows : (i + 1) * rows] = x
    cur = list(xs)
    for step in range(n - 1):
        cur = ppermute_shift(cur, 1)
        for i, out in enumerate(outs):
            src = (i - step - 1) % n
            out[src * rows : (src + 1) * rows] = cur[i]
    return outs
