"""Triplet miners (reference ``src/model/triplet_miners.py``), the port's
counterpart of the JAX package's ``train/miners.py``.

All ten registry names (``get_miner``). The similarity-driven miners (the
k×k kernel miners and the temporal ones) run on the device. The
morphology-driven miners (distance transform, skeleton) have two modes,
chosen by ``train.loop.mining_mode``:

* the host path (mode ``callback``, the default on the CPU): SciPy on the
  host, as the reference's ``.cpu().numpy()`` round trips do
  (``triplet_miners.py:187-191``), from the step's embeddings;
* ``pipelined`` (the default on the card): the SciPy work depends only on
  the label image, so :func:`host_geometry` runs it on the staging thread
  before the step, and the embedding-dependent picks run on the device
  (:meth:`DistanceTransformationMiner.mine_from_geometry`). The triplet set
  is the same, without a device → host → device round trip in the step.

Every miner returns a fixed budget of gathered triplets
``(anchors, positives, negatives, valid)``, shaped (B, N, C) and (B, N), N
being ``max_triplets`` when set and ``DEFAULT_BUDGET`` otherwise. Where more
triplets exist than fit, a random subset is kept (``limit_triplets``,
``triplet_miners.py:50-67``), drawn from the ``torch.Generator`` the step
passes in. The selection is on indices, so gradients flow through the
gathered embeddings only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DEFAULT_BUDGET = 1024
_BIG = 10.0  # the reference's "excluded from argmin" value (triplet_miners.py:103-104)


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``F.normalize``: x / max(||x||, eps) over the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _cosine_sim_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, C) → (B, N, M) cosines. The reference takes
    ``1 - cdist`` of the normalised vectors, which orders pairs as the
    cosine does; it only enters argmin / argmax."""
    return torch.bmm(_l2_normalize(a.float()), _l2_normalize(b.float()).transpose(1, 2))


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def _limit(generator, idx_a, idx_p, idx_n, valid, budget: int):
    """Pad to the budget, or keep a random ``budget`` of each row's triplets
    (``limit_triplets``)."""
    b, n = idx_a.shape
    if n <= budget:
        pad = lambda x: torch.nn.functional.pad(x, (0, budget - n))  # noqa: E731
        return pad(idx_a), pad(idx_p), pad(idx_n), pad(valid)
    take = torch.argsort(_uniform((b, n), generator, idx_a.device), dim=1)[:, :budget]
    g = lambda x: torch.gather(x, 1, take)  # noqa: E731
    return g(idx_a), g(idx_p), g(idx_n), g(valid)


@dataclasses.dataclass
class AbstractMiner:
    """A fixed triplet budget and the gather helper."""

    max_triplets: int = 0

    @property
    def budget(self) -> int:
        return self.max_triplets if self.max_triplets > 0 else DEFAULT_BUDGET

    def mine(self, embeddings, labels, prediction, generator):
        raise NotImplementedError

    @staticmethod
    def _gather(flat_emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """(B, P, C) gathered at (B, N) → (B, N, C)."""
        return torch.gather(flat_emb, 1, idx.long()[..., None].expand(-1, -1, flat_emb.shape[-1]))


@dataclasses.dataclass
class KernelMiner(AbstractMiner):
    """Reference ``triplet_miners.py:78-125``: non-overlapping k×k patches;
    anchor = the patch centre, positive = the least similar same-label pixel
    of the patch, negative = the most similar other-label pixel anywhere."""

    kernel_size: int = 3
    stride: int = 3

    def mine(self, embeddings, labels, prediction, generator):
        b, h, w, c = embeddings.shape
        k, s = self.kernel_size, self.stride
        ph, pw = (h - k) // s + 1, (w - k) // s + 1
        emb = embeddings[:, : ph * k, : pw * k].detach().float()  # the picks carry no gradient
        lab = labels[:, : ph * k, : pw * k]
        patches = emb.reshape(b, ph, k, pw, k, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, k * k, c)
        plabs = lab.reshape(b, ph, k, pw, k).permute(0, 1, 3, 2, 4).reshape(b, ph * pw, k * k)

        centre = (k * k) // 2
        anchors = patches[:, :, centre]  # (B, NP, C)
        anchor_labels = plabs[:, :, centre]
        sim = torch.einsum("bnc,bnkc->bnk", _l2_normalize(anchors), _l2_normalize(patches))
        sim = torch.where(plabs != anchor_labels[:, :, None], torch.full_like(sim, _BIG), sim)
        sim[:, :, centre] = _BIG
        pos_in_patch = torch.argmin(sim, dim=-1)  # (B, NP)

        dev = embeddings.device
        np_idx = torch.arange(ph * pw, device=dev)
        py, px = np_idx // pw, np_idx % pw
        ky, kx = pos_in_patch // k, pos_in_patch % k
        pos_flat = (py[None] * s + ky) * w + (px[None] * s + kx)
        anchor_flat = ((py * s + centre // k) * w + (px * s + centre % k))[None].expand(b, -1)

        # the hardest negative anywhere in the frame (triplet_miners.py:115-125)
        flat_emb = embeddings.reshape(b, h * w, c)
        flat_lab = labels.reshape(b, h * w)
        invalid = anchor_labels[:, :, None] == flat_lab[:, None, :]
        dist = torch.where(invalid, torch.full((), -1.0, device=dev), _cosine_sim_matrix(anchors, flat_emb.detach()))
        neg_flat = torch.argmax(dist, dim=-1)
        # no pixel of another label: the argmax points at pixel 0, so invalid
        has_neg = (~invalid).any(-1)

        a_i, p_i, n_i, valid = _limit(generator, anchor_flat, pos_flat, neg_flat, has_neg.float(), self.budget)
        return self._gather(flat_emb, a_i), self._gather(flat_emb, p_i), self._gather(flat_emb, n_i), valid


@dataclasses.dataclass
class TemporalMiner(AbstractMiner):
    """Reference ``triplet_miners.py:128-159``: anchors = the last frame's
    pixels; positive = the least similar same-label pixel of the earlier
    frames, negative = the most similar other-label one."""

    def mine(self, embeddings, labels, prediction, generator):
        b, t, h, w, c = embeddings.shape
        last = embeddings[:, -1].reshape(b, h * w, c)
        cand = embeddings[:, :-1].reshape(b, (t - 1) * h * w, c)
        same = labels[:, -1].reshape(b, h * w)[:, :, None] == labels[:, :-1].reshape(b, (t - 1) * h * w)[:, None, :]
        sim = _cosine_sim_matrix(last.detach(), cand.detach())  # (B, HW, (T-1)HW)
        neg_idx = torch.argmax(torch.where(same, torch.full_like(sim, -1.0), sim), dim=-1)
        pos_idx = torch.argmin(torch.where(same, sim, torch.full_like(sim, _BIG)), dim=-1)
        has_both = same.any(-1) & (~same).any(-1)
        anchor_idx = torch.arange(h * w, device=embeddings.device)[None].expand(b, -1)
        a_i, p_i, n_i, valid = _limit(generator, anchor_idx, pos_idx, neg_idx, has_both.float(), self.budget)
        return self._gather(last, a_i), self._gather(cand, p_i), self._gather(cand, n_i), valid


@dataclasses.dataclass
class OneBackOneAheadMiner(TemporalMiner):
    """The temporal miner (``triplet_miners.py:162-168``); the frames it sees
    are chosen by the train step (``train.py:191-199``)."""


def _host_morphology_mine(embeddings, labels, seeds, budget, mode, metric):
    """The host path of the distance-transform and skeleton miners.

    ``embeddings`` (B, H, W, C) and ``labels`` (B, H, W) are numpy arrays.
    Returns flat-pixel index triplets padded to ``budget`` and a validity
    mask; ``mode`` is 'distance' (``triplet_miners.py:171-224``), 'skeleton'
    (``:227-285``) or 'skeleton_distance' (``:288-359``)."""
    from semi_supervised_vos_tpu_torch.utils.morphology import distance_transform, skeletonize

    b, h, w, c = embeddings.shape
    out_a = np.zeros((b, budget), np.int32)
    out_p = np.zeros((b, budget), np.int32)
    out_n = np.zeros((b, budget), np.int32)
    out_v = np.zeros((b, budget), np.float32)

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    for bi in range(b):
        emb, lab = embeddings[bi], labels[bi]
        anchors, positives, negatives = [], [], []
        for label in np.unique(lab):
            mask = (lab == label).astype(np.int32)
            if mode == "distance":
                distances, indices = distance_transform(mask, metric, return_indices=True)
                pix = np.argwhere(distances != 0)
                if len(pix) == 0:
                    continue
                # positives: the least similar pixel of the interior pool
                cand_emb = norm(emb[pix[:, 0], pix[:, 1]])
                pos_pick = np.argmin(cand_emb @ cand_emb.T, axis=1)
                for a_k, (i, j) in enumerate(pix):
                    anchors.append(i * w + j)
                    x, y = indices[:, i, j]
                    negatives.append(x * w + y)
                    pi, pj = pix[pos_pick[a_k]]
                    positives.append(pi * w + pj)
                continue
            skel = skeletonize(mask)
            if mode == "skeleton":
                a_pix = np.argwhere(skel == 1)
                n_pix = np.argwhere(mask == 0)
                p_mask = mask == 1
                if len(a_pix) == 0 or len(n_pix) == 0 or not p_mask.any():
                    continue
                p_pix = np.argwhere(p_mask)
                a_emb = norm(emb[a_pix[:, 0], a_pix[:, 1]])
                pos_pick = np.argmin(a_emb @ norm(emb[p_pix[:, 0], p_pix[:, 1]]).T, axis=1)
                neg_pick = np.argmax(a_emb @ norm(emb[n_pix[:, 0], n_pix[:, 1]]).T, axis=1)
                for a_k, (i, j) in enumerate(a_pix):
                    anchors.append(i * w + j)
                    pi, pj = p_pix[pos_pick[a_k]]
                    positives.append(pi * w + pj)
                    ni, nj = n_pix[neg_pick[a_k]]
                    negatives.append(ni * w + nj)
            else:  # skeleton_distance
                distances, indices = distance_transform(mask, metric, return_indices=True)
                a_pix = np.argwhere(np.logical_and(distances != 0, skel == 1))
                p_mask = np.logical_and(mask == 1, skel == 0)
                if len(a_pix) == 0 or not p_mask.any():
                    continue
                p_pix = np.argwhere(p_mask)
                a_emb = norm(emb[a_pix[:, 0], a_pix[:, 1]])
                pos_pick = np.argmin(a_emb @ norm(emb[p_pix[:, 0], p_pix[:, 1]]).T, axis=1)
                for a_k, (i, j) in enumerate(a_pix):
                    anchors.append(i * w + j)
                    x, y = indices[:, i, j]
                    negatives.append(x * w + y)
                    pi, pj = p_pix[pos_pick[a_k]]
                    positives.append(pi * w + pj)
        n_found = len(anchors)
        if n_found == 0:
            continue
        take = np.random.default_rng(int(seeds[bi])).permutation(n_found)[:budget]
        out_a[bi, : len(take)] = np.asarray(anchors, np.int32)[take]
        out_p[bi, : len(take)] = np.asarray(positives, np.int32)[take]
        out_n[bi, : len(take)] = np.asarray(negatives, np.int32)[take]
        out_v[bi, : len(take)] = 1.0
    return out_a, out_p, out_n, out_v


def host_geometry(labels, mode: str, metric: str):
    """The label-only morphology of the pipelined mode.

    Everything the morphology miners take from SciPy depends on the label
    image alone, so it runs on the host before the step; the
    embedding-dependent picks run on the device
    (:meth:`DistanceTransformationMiner.mine_from_geometry`).

    Args:
      labels: (B, H, W) integer array, the image the host path mines from.
      mode / metric: as on the miner.

    Returns three (B, H·W) numpy arrays:
      interior: int32, the pixel's label where its region's distance
        transform is non-zero, else -1 (all -1 for 'skeleton');
      skel: bool, the pixel is on its region's skeleton (all False for
        'distance');
      nb_idx: int32, the flat index of the nearest boundary pixel where
        interior, else 0.
    """
    from semi_supervised_vos_tpu_torch.utils.morphology import distance_transform, skeletonize_many

    labels = np.asarray(labels)
    b, h, w = labels.shape
    p = h * w
    interior = np.full((b, p), -1, np.int32)
    skel = np.zeros((b, p), bool)
    nb_idx = np.zeros((b, p), np.int32)
    regions = [(bi, label) for bi in range(b) for label in np.unique(labels[bi])]
    if mode in ("distance", "skeleton_distance"):
        for bi, label in regions:
            distances, indices = distance_transform((labels[bi] == label).astype(np.int32), metric,
                                                    return_indices=True)
            inside = (distances != 0).reshape(p)
            interior[bi, inside] = label
            nb_idx[bi, inside] = (indices[0] * w + indices[1]).reshape(p)[inside]
    if mode in ("skeleton", "skeleton_distance"):
        # every region of the batch thinned at once
        thin = skeletonize_many(np.stack([labels[bi] == label for bi, label in regions]))
        for (bi, _), region_skel in zip(regions, thin):
            skel[bi] |= region_skel.reshape(p) == 1
    return interior, skel, nb_idx


@dataclasses.dataclass
class DistanceTransformationMiner(AbstractMiner):
    """Reference ``triplet_miners.py:171-224``: anchors = region-interior
    pixels, negative = the nearest boundary pixel (distance-transform
    indices), positive = the least similar pixel of the region's interior."""

    metric: str = "euclidean"
    mode: str = "distance"

    def mine_from_geometry(self, embeddings, labels, geometry, generator):
        """The pipelined mode: ``geometry`` is :func:`host_geometry` of this
        batch's label image, as device tensors."""
        b, h, w, c = embeddings.shape
        fe = embeddings.reshape(b, h * w, c)
        a_i, p_i, n_i, valid = self.mine_indices_from_geometry(embeddings, labels, geometry, generator)
        return self._gather(fe, a_i), self._gather(fe, p_i), self._gather(fe, n_i), valid

    def mine_indices_from_geometry(self, embeddings, labels, geometry, generator):
        """(B, budget) anchor, positive and negative flat-pixel indices and a
        float validity mask. Anchors are subsampled to the budget uniformly
        (every anchor gives one triplet, so this is ``limit_triplets``)."""
        b, h, w, c = embeddings.shape
        p = h * w
        dev = embeddings.device
        flat_lab = labels.reshape(b, p)
        interior, skel, nb_idx = geometry
        if self.mode == "distance":
            a_valid = interior >= 0
        elif self.mode == "skeleton":
            a_valid = skel
        else:  # skeleton_distance
            a_valid = skel & (interior >= 0)

        na = min(p, self.budget)
        scores = torch.where(a_valid, _uniform((b, p), generator, dev), torch.full((), 2.0, device=dev))
        a_idx = torch.argsort(scores, dim=-1)[:, :na]  # invalid anchors sort last
        take = lambda x: torch.gather(x, 1, a_idx)  # noqa: E731
        a_valid = take(a_valid)

        nemb = _l2_normalize(embeddings.detach().reshape(b, p, c).float())
        sims = torch.bmm(self._gather(nemb, a_idx), nemb.transpose(1, 2))  # (B, NA, P)
        if self.mode == "distance":
            # the positive pool: the anchor region's interior, the anchor included
            pos_ok = take(interior)[:, :, None] == interior[:, None, :]
            neg_idx = take(nb_idx)
        elif self.mode == "skeleton":
            same = take(flat_lab)[:, :, None] == flat_lab[:, None, :]
            pos_ok = same
            # below any cosine: -1 could tie with an antiparallel negative
            neg_idx = torch.argmax(torch.where(same, torch.full_like(sims, -1e30), sims), dim=-1)
            a_valid = a_valid & (~same).any(-1)
        else:  # skeleton_distance: the positives exclude the skeleton
            pos_ok = (take(flat_lab)[:, :, None] == flat_lab[:, None, :]) & ~skel[:, None, :]
            neg_idx = take(nb_idx)
            a_valid = a_valid & pos_ok.any(-1)
        pos_idx = torch.argmin(torch.where(pos_ok, sims, torch.full_like(sims, _BIG)), dim=-1)

        pad = lambda x: torch.nn.functional.pad(x, (0, self.budget - na))  # noqa: E731
        return pad(a_idx), pad(pos_idx), pad(neg_idx.long()), pad(a_valid.float())

    def mine(self, embeddings, labels, prediction, generator):
        """The host path: SciPy and the picks on the host from the step's
        embeddings, the gather on the device."""
        b, h, w, c = embeddings.shape
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=generator, device=generator.device).tolist()
        idx = _host_morphology_mine(embeddings.detach().float().cpu().numpy(), labels.cpu().numpy(), seeds,
                                    self.budget, self.mode, self.metric)
        a_i, p_i, n_i, valid = (torch.as_tensor(x, device=embeddings.device) for x in idx)
        fe = embeddings.reshape(b, h * w, c)
        return self._gather(fe, a_i), self._gather(fe, p_i), self._gather(fe, n_i), valid


@dataclasses.dataclass
class SkeletonMiner(DistanceTransformationMiner):
    """Reference ``triplet_miners.py:227-285``."""

    metric: str = "euclidean"
    mode: str = "skeleton"


@dataclasses.dataclass
class SkeletonWithDistanceTransformMiner(DistanceTransformationMiner):
    """Reference ``triplet_miners.py:288-359`` (manhattan by default)."""

    metric: str = "manhattan"
    mode: str = "skeleton_distance"


@dataclasses.dataclass
class SkeletonTemporalMiner(SkeletonMiner):
    """The skeleton miner (``triplet_miners.py:362-368``) on five frames
    stacked into one tall image by the train step (``train.py:200-204``)."""


def get_miner(miner_name: str) -> Optional[AbstractMiner]:
    """The registry (reference ``triplet_miners.py:21-32``)."""
    miners = {
        "default": lambda: KernelMiner(kernel_size=3, stride=3),
        "kernel_7x7": lambda: KernelMiner(kernel_size=7, stride=7),
        "temporal": TemporalMiner,
        "one_back_one_ahead": OneBackOneAheadMiner,
        "euclidean": lambda: DistanceTransformationMiner(metric="euclidean"),
        "manhattan": lambda: DistanceTransformationMiner(metric="manhattan"),
        "chebyshev": lambda: DistanceTransformationMiner(metric="chessboard"),
        "skeleton": SkeletonMiner,
        "skeleton_nearest_negative": SkeletonWithDistanceTransformMiner,
        "skeleton_temporal": SkeletonTemporalMiner,
    }
    make = miners.get(miner_name)
    return make() if make is not None else None
