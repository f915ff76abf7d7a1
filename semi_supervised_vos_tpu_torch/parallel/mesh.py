"""Device meshes: the PyTorch counterpart of
``semi_supervised_vos_tpu/parallel/mesh.py``.

The JAX package runs one process that controls a named ``jax.sharding.Mesh``
of all its devices: the ``data`` axis shards lockstep video lanes and the
``model`` axis shards each memory bank's pixel rows. The port keeps that
design: one process, and a :class:`Mesh` that is an ``(n_data, n_model)``
grid of ``torch.device`` objects with the same axis names. The engines drive
every device of the grid from this process; there is no process group.

A mesh may name a device more than once. ``[cuda:0] * 4`` runs four bank
shards, with their row offsets and the real combine of their statistics, on
one card; ``[cpu] * 8`` plays the role of the 8 virtual host devices of the
JAX package's tests.

``data_sharding`` and ``replicated`` (JAX ``NamedSharding`` objects) have no
counterpart: a tensor here lies on one device, so the engines keep a list
of per-shard tensors where JAX keeps one sharded array. :func:`shard_batch`
and :func:`replicate` place those per-shard copies.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

AXES = ("data", "model")


class Mesh:
    """An ``(n_data, n_model)`` grid of devices with axes ``("data",
    "model")``. ``devices[r]`` is data row r: the ``n_model`` devices over
    which that row's banks shard their pixel rows."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or any(len(r) != len(self.devices[0]) for r in self.devices):
            raise ValueError(f"a mesh needs a non-empty rectangular grid of devices, got {devices!r}")
        if len({d.type for row in self.devices for d in row}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {devices!r}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def distinct_devices(self) -> List[torch.device]:
        """Every device of the grid once, in row-major order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices})"


def _cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the mesh's devices explicitly (e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A ``("data", "model")`` mesh over the first ``n_data · n_model`` of
    ``devices`` (default: every CUDA device), row-major. ``devices`` may
    repeat a device."""
    devices = list(devices) if devices is not None else _cuda_devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"a {n_data} x {n_model} mesh needs more than the {len(devices)} device(s) given")
    return Mesh([devices[r * n_model : (r + 1) * n_model] for r in range(n_data)])


def _to(tree, dev: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_to(v, dev) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)  # a named tuple takes fields
    return tree


def replicate(mesh: Mesh, tree) -> Dict[torch.device, object]:
    """One copy of ``tree`` (a tensor, or dicts, lists and tuples, named
    tuples too, of them: the folded encoder table) on each distinct device
    of the mesh, keyed by device. A copy already on a device is the same
    object there."""
    return {dev: _to(tree, dev) for dev in mesh.distinct_devices}


def shard_batch(mesh: Mesh, *arrays, pin: bool = False) -> tuple:
    """Each (B, ...) array (numpy or torch) cut along its leading axis into
    ``n_data`` equal blocks, block r on the first device of data row r: one
    list of per-row tensors for each array. B must divide by ``n_data``.
    ``pin``: copy each host block from pinned memory without blocking, on
    the destination's current stream (the train loop's staging thread)."""
    n = mesh.shape["data"]
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        if t.shape[0] % n:
            raise ValueError(f"leading axis {t.shape[0]} does not divide over {n} data rows")
        if pin:
            out.append([blk.contiguous().pin_memory().to(row[0], non_blocking=True)
                        for blk, row in zip(t.chunk(n), mesh.devices)])
        else:
            out.append([blk.to(row[0]) for blk, row in zip(t.chunk(n), mesh.devices)])
    return tuple(out)
