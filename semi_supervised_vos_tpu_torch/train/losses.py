"""Training losses (reference ``src/model/loss.py``), the port's counterpart
of the JAX package's ``train/losses.py``.

Layouts are channels-last, as there: ref (B, R, H, W, C), target
(B, H, W, C), ref_label (B, R, H, W, D) one-hot, target_label (B, H, W)
integer. Everything is float32 (the products are ``torch.bmm``).

Kept from the JAX package, which documents why:
  * the focal loss has a working signature, a second log-softmax over the
    propagated class scores, and ``mean(focal_term) * mean_ce``;
  * the triplet loss's cosine "distance" runs over the feature axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from semi_supervised_vos_tpu_torch.core.propagation import batch_predict, batch_similarity

EPS = 1e-14


def _propagated_log_probs(ref, target, ref_label, temperature):
    sim = batch_similarity(ref, target) * temperature  # (B, R*H*W, H*W)
    pred = batch_predict(torch.softmax(sim, dim=1), ref_label)  # (B, H, W, D)
    return torch.log(pred + EPS)


def _nll(log_probs: torch.Tensor, target_label: torch.Tensor) -> torch.Tensor:
    return -torch.gather(log_probs, -1, target_label[..., None].long())[..., 0].mean()


def cross_entropy_loss(ref, target, ref_label, target_label, *, temperature: float = 1.0,
                       return_prediction: bool = False):
    """Reference ``loss.py:39-66``."""
    log_probs = _propagated_log_probs(ref, target, ref_label, temperature)
    loss = _nll(log_probs, target_label)
    if return_prediction:
        return loss, torch.argmax(log_probs, dim=-1)
    return loss


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``nn.CosineSimilarity`` with each norm clamped to 1e-8."""
    eps = 1e-8
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=eps)
    return (a * b).sum(dim) / (na * nb)


def contrastive_loss(ref, target, ref_label, target_label, *, temperature: float = 1.0):
    """Reference ``loss.py:69-99``: cross-entropy plus a cosine embedding
    loss (margin 0) between the last reference frame and the target, keyed
    on whether each pixel's prediction is right."""
    log_probs = _propagated_log_probs(ref, target, ref_label, temperature)
    loss = _nll(log_probs, target_label)
    correct = torch.argmax(log_probs, dim=-1) == target_label
    cos = cosine_similarity(ref[:, -1].float(), target.float())
    per_pixel = torch.where(correct, 1.0 - cos, torch.clamp(cos, min=0.0))
    return loss + per_pixel.mean()


def triplet_margin_loss(anchors, positives, negatives, valid: Optional[torch.Tensor] = None,
                        margin: float = 1.0) -> torch.Tensor:
    """``nn.TripletMarginWithDistanceLoss`` with cosine similarity as the
    "distance" (reference ``loss.py:107``): the mean of
    ``max(d(a, p) - d(a, n) + margin, 0)`` over the valid triplets."""
    per = torch.clamp(cosine_similarity(anchors, positives) - cosine_similarity(anchors, negatives) + margin, min=0.0)
    if valid is None:
        return per.mean()
    return (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def triplet_loss_with_miner(ref, target, ref_label, target_label, miner, *, generator, extra_embeddings=None,
                            extra_labels=None, margin: float = 1.0, weights: Tuple[float, float] = (1.0, 1.0),
                            temperature: float = 1.0, geometry=None):
    """Reference ``loss.py:102-134``: cross-entropy and the mined triplet
    margin loss, their weighted sum over the weights' total. With
    ``geometry`` (the host label morphology of ``train.loop.make_geometry_fn``)
    the morphology miners pick on the device (the pipelined mode)."""
    ce, prediction = cross_entropy_loss(ref, target, ref_label, target_label, temperature=temperature,
                                        return_prediction=True)
    emb = target if extra_embeddings is None else extra_embeddings
    lab = target_label if extra_labels is None else extra_labels
    if geometry is not None:
        anchors, positives, negatives, valid = miner.mine_from_geometry(emb, lab, geometry, generator)
    else:
        anchors, positives, negatives, valid = miner.mine(emb, lab, prediction, generator)
    metric = triplet_margin_loss(anchors.float(), positives.float(), negatives.float(), valid, margin)
    # a miner that found nothing adds 0 (reference loss.py:129-132)
    metric = torch.where(valid.sum() > 0, metric, torch.zeros_like(metric))
    w0, w1 = weights
    return (ce * w0 + metric * w1) / (w0 + w1)


def focal_loss(ref, target, ref_label, target_label, *, gamma: float = 0.5, reduction: str = "mean"):
    """Reference ``loss.py:137-184``: no temperature, and a second
    log-softmax over the propagated class scores."""
    sim = batch_similarity(ref, target)
    pred = batch_predict(torch.softmax(sim, dim=1), ref_label)  # (B, H, W, D)
    log_p = torch.log_softmax(pred.reshape(-1, pred.shape[-1]), dim=-1)
    log_pt = torch.gather(log_p, 1, target_label.reshape(-1, 1).long())[:, 0]
    ce = -log_pt.mean()
    loss = (1.0 - torch.exp(log_pt)) ** gamma * ce  # the scalar ce scales every pixel's focal term
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
