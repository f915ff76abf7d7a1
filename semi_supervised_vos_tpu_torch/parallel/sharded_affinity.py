"""Memory-bank-sharded affinity: the PyTorch counterpart of
``semi_supervised_vos_tpu/parallel/sharded_affinity.py``.

The memory bank is the propagation's context: K·P reference pixels score
every target pixel. Sharding it over devices splits the softmax, and the
shards' partial statistics combine exactly (the flash- / ring-attention
decomposition):

  local:  m_i = max(sim_i);  l_i = Σ exp(sim_i − m_i);  acc_i = labels_i @ (w·exp(sim_i − m_i))
  global: m = max m_i;  out = Σ acc_i·exp(m_i − m) / Σ l_i·exp(m_i − m)

The Gaussian prior multiplies the numerator only; the denominator stays
unweighted, as on one device (reference ``predict.py:55-66``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from semi_supervised_vos_tpu_torch.core.propagation import NEG_INF
from semi_supervised_vos_tpu_torch.ops.affinity import combine_partials
from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh


def distributed_softmax_combine(
    m: Sequence[torch.Tensor], l: Sequence[torch.Tensor], acc: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Combine per-shard online-softmax statistics (m, l (..., P) and acc
    (..., D, P), float32, shard i on its own device) into the (..., D, P)
    scores on the first shard's device:

      out = Σ acc·exp(m − max m) / max(Σ l·exp(m − max m), 1e-30)

    The shards are gathered to the first device and stacked as the split
    axis of ``ops/affinity.py::combine_partials``: the combine kernel of
    ``csrc/affinity_bank.cu`` on a CUDA tensor (the formula and the 1e-30
    clamp of the JAX function), its plain version on a CPU tensor. A shard
    that holds only padding rows carries m = −1e30; its weight
    exp(−1e30 − max m) is 0."""
    dev = m[0].device
    lead = tuple(m[0].shape[:-1])
    p = m[0].shape[-1]
    d = acc[0].shape[-2]

    def stack(xs, shape):
        return torch.stack([x.to(dev).reshape(shape) for x in xs]).contiguous()

    out = combine_partials(stack(m, (-1, p)), stack(l, (-1, p)), stack(acc, (-1, d, p)))
    return out.reshape(lead + (d, p))


def _local_stats(ref_f, tgt, ref_l, valid, prior, temperature):
    """One shard's online-softmax statistics (m, l (P_t,), acc (D, P_t)) of
    its K reference frames; invalid slots are masked, ``prior`` (K, P,
    P_t) or None weights the numerator."""
    sim = torch.einsum("kpc,qc->kpq", ref_f.float(), tgt.float()) * temperature
    sim = torch.where(valid[:, None, None], sim, torch.full_like(sim, NEG_INF))
    m = sim.amax(dim=(0, 1))
    e = torch.where(valid[:, None, None], torch.exp(sim - m), torch.zeros_like(sim))
    l = e.sum(dim=(0, 1))
    if prior is not None:
        e = e * prior
    return m, l, torch.einsum("kpd,kpq->dq", ref_l.float(), e)


def sharded_affinity_propagate(
    mesh: Mesh,
    ref_feats: torch.Tensor,
    target_feat: torch.Tensor,
    ref_labels: torch.Tensor,
    *,
    temperature: float,
    valid: Optional[torch.Tensor] = None,
    dense: Optional[torch.Tensor] = None,
    weight_dense: Optional[torch.Tensor] = None,
    weight_sparse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in sharded equivalent of ``core.propagation.affinity_propagate``
    (same arguments and (D, P_t) float32 result, on the first device of the
    mesh's ``model`` axis). The K reference frames shard over that axis;
    the target and the priors go to every shard, and each shard's
    statistics go through :func:`distributed_softmax_combine`. K that does
    not divide by the axis is padded with masked slots (a shard of padding
    alone carries m = −1e30 and weight 0). Plain PyTorch statistics on any
    device. No engine calls it; it is the counterpart of the JAX function."""
    devices = mesh.devices[0]
    n = len(devices)
    k = ref_feats.shape[0]
    dev0 = ref_feats.device
    valid = torch.ones(k, dtype=torch.bool, device=dev0) if valid is None else valid.to(dev0)
    dense = torch.ones(k, dtype=torch.bool, device=dev0) if dense is None else dense.to(dev0)
    pad = -k % n
    if pad:
        ref_feats = torch.nn.functional.pad(ref_feats, (0, 0, 0, 0, 0, pad))
        ref_labels = torch.nn.functional.pad(ref_labels, (0, 0, 0, 0, 0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
        dense = torch.nn.functional.pad(dense, (0, pad))
    per = ref_feats.shape[0] // n
    stats = []
    for i, dev in enumerate(devices):
        blk = slice(i * per, (i + 1) * per)
        prior = None
        if weight_dense is not None:
            wd = weight_dense.to(dev)
            ws = weight_sparse.to(dev) if weight_sparse is not None else torch.zeros_like(wd)
            prior = torch.where(dense[blk].to(dev)[:, None, None], wd[None], ws[None])
        stats.append(_local_stats(ref_feats[blk].to(dev), target_feat.to(dev), ref_labels[blk].to(dev),
                                  valid[blk].to(dev), prior, temperature))
    return distributed_softmax_combine(*zip(*stats))
