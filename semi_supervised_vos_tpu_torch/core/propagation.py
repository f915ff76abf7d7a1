"""Label-propagation affinity math: the dense golden path (reference
``src/model/predict.py:19-71``).

1. similarity = ref_features (K*P, C) @ target_features (C, P);
2. multiplied by ``temperature``;
3. softmax over *all* K*P reference pixels, invalid slots biased by −1e30;
4. **post-softmax** multiplication by the Gaussian spatial weight (dense
   prior for the slots flagged ``dense``, sparse otherwise); the softmax
   denominator stays unweighted;
5. prediction = ref_labels (D, K*P) @ weighted similarity (K*P, P).

The engine runs this on the CPU; on the card it runs the fused CUDA kernel
(:mod:`semi_supervised_vos_tpu_torch.ops.affinity`).

Training uses the batched forms :func:`batch_similarity` and
:func:`batch_predict` (reference ``src/model/loss.py:13-36``), plain
float32 products on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def affinity_logits(
    ref_feats: torch.Tensor,
    target_feat: torch.Tensor,
    temperature: float,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled similarity logits: (K, P, C) reference and (P_t, C) target
    features → (K, P, P_t) float32, times ``temperature`` (the reference
    multiplies, ``predict.py:52``), invalid slots (``valid`` (K,) bool) at
    NEG_INF."""
    sim = torch.einsum("kpc,qc->kpq", ref_feats.float(), target_feat.float()) * temperature
    if valid is not None:
        sim = torch.where(valid[:, None, None], sim, torch.full_like(sim, NEG_INF))
    return sim


def affinity_propagate(
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
    """Propagate labels from the sampled bank to the target frame.

    Args:
      ref_feats: (K, P, C) sampled reference features.
      target_feat: (P_t, C) target features.
      ref_labels: (K, P, D) per-pixel label distribution.
      valid: (K,) bool — slot participates (None = all).
      dense: (K,) bool — slot uses ``weight_dense`` (None = all dense).
      weight_dense / weight_sparse: (P, P_t) Gaussian weights; both None
        disables spatial weighting (probability propagation).

    Returns:
      (D, P_t) float32 scores.
    """
    k = ref_feats.shape[0]
    sim = affinity_logits(ref_feats, target_feat, temperature, valid)

    m = torch.amax(sim, dim=(0, 1), keepdim=True)
    e = torch.exp(sim - m)
    if valid is not None:
        e = torch.where(valid[:, None, None], e, torch.zeros_like(e))
    denom = torch.sum(e, dim=(0, 1), keepdim=True)
    soft = e / torch.clamp(denom, min=1e-30)

    if weight_dense is not None:
        if dense is None:
            dense = torch.ones(k, dtype=torch.bool, device=sim.device)
        sparse = weight_sparse if weight_sparse is not None else torch.zeros_like(weight_dense)
        w = torch.where(dense[:, None, None], weight_dense[None], sparse[None])
        soft = soft * w

    return torch.einsum("kpd,kpq->dq", ref_labels.float(), soft)


def batch_similarity(ref: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W, C) reference and (B, H, W, C) target features →
    (B, N·H·W, H·W) float32 similarity."""
    b, n, h, w, c = ref.shape
    return torch.bmm(ref.reshape(b, n * h * w, c).float(), target.reshape(b, h * w, c).float().transpose(1, 2))


def batch_predict(global_similarity: torch.Tensor, ref_label: torch.Tensor) -> torch.Tensor:
    """(B, N·H·W, H·W) weights and (B, N, H, W, D) one-hot labels → (B, H, W, D)
    propagated scores."""
    b, n, h, w, d = ref_label.shape
    out = torch.bmm(global_similarity.transpose(1, 2), ref_label.reshape(b, n * h * w, d).float())
    return out.reshape(b, h, w, d)
