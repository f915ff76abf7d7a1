"""Bank-direct fused affinity: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``semi_supervised_vos_tpu/ops/affinity_pallas.py::
affinity_from_bank_batched`` (and its ``affinity_from_bank`` /
``affinity_from_bank_stats`` wrappers). The kernel is
``csrc/affinity_bank.cu``; see its header for the design and what bounds it.

Per target pixel, the K sampled slots stream straight from the ring bank by
slot index: similarity ``ref·(T·tgt)`` with −1e30 biases on padded rows and
invalid slots, an online softmax with an **unweighted** denominator, the
Gaussian prior ``exp(−((yᵣ−yₜ)²+(xᵣ−xₜ)²)·invσ²_slot)`` built from pixel
indices (``y = idx / wd`` fractional, rows offset by ``row_base``) and
applied after the softmax, and the label aggregation. invσ² = 0 is
probability mode.

On a CPU tensor the wrapper runs :func:`affinity_from_bank_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30
MAX_SLOTS = 16


def slot_table(
    slots: Sequence[int],
    valid: Optional[Sequence[bool]],
    dense: Optional[Sequence[bool]],
    sigma_1: float,
    sigma_2: float,
    spatial: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (slots int32, inv_sigma2 f32, bias f32), each (K,): the per-slot
    launch arguments. inv_sigma2 == 0 turns the prior off."""
    slots = np.asarray(slots, np.int32).reshape(-1)
    k = slots.shape[0]
    valid = np.ones(k, bool) if valid is None else np.asarray(valid, bool)
    dense = np.ones(k, bool) if dense is None else np.asarray(dense, bool)
    if spatial:
        inv_sigma2 = np.where(dense, 1.0 / (sigma_1**2), 1.0 / (sigma_2**2))
    else:
        inv_sigma2 = np.zeros(k)
    bias = np.where(valid, 0.0, NEG_INF)
    return slots, inv_sigma2.astype(np.float32), bias.astype(np.float32)


def affinity_from_bank_plain(
    bank_feats: torch.Tensor,
    bank_labels: torch.Tensor,
    target_feats: torch.Tensor,
    slots,
    *,
    feature_hw: Tuple[int, int],
    temperature: float,
    valid=None,
    dense=None,
    sigma_1: float = 8.0,
    sigma_2: float = 21.0,
    spatial: bool = True,
    row_base: int = 0,
    return_stats: bool = False,
):
    """Plain PyTorch version of the kernel (same arguments and results as
    :func:`affinity_from_bank_batched`): a dense softmax over all K·P_loc
    reference rows, with the kernel's rounding points — the target is
    rounded to the bank dtype after the temperature, and ``e·w`` is split
    into a label-dtype ``hi`` and ``lo`` part before the label product. With
    float32 banks it is the golden math. No far-tile skip: the rows it would
    drop carry weight ≤ exp(−36)."""
    cap, b, p_loc, c = bank_feats.shape
    hd, wd = feature_hw
    p = hd * wd
    slots, inv_sigma2, bias = slot_table(slots, valid, dense, sigma_1, sigma_2, spatial)
    dev = bank_feats.device
    idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
    ref = bank_feats.index_select(0, idx).float()  # (K, B, P_loc, C)
    lab = bank_labels.index_select(0, idx).float()  # (K, B, P_loc, D)
    tgt = (target_feats.float() * temperature).to(bank_feats.dtype).float()  # (B, P, C)
    s = torch.einsum("kbrc,bqc->bkrq", ref, tgt)  # (B, K, P_loc, P)

    ridx = row_base + torch.arange(p_loc, device=dev)
    pad_bias = torch.where(ridx < p, 0.0, NEG_INF).float()
    s = s + pad_bias[None, None, :, None] + torch.as_tensor(bias, device=dev)[None, :, None, None]
    # the kernel's running max starts at −1e30
    m = torch.clamp(torch.amax(s, dim=(1, 2), keepdim=True), min=NEG_INF)
    e = torch.exp(s - m)
    l = e.sum(dim=(1, 2))  # (B, P)

    q = torch.arange(p, device=dev)
    dy = (ridx.float() / float(wd))[:, None] - (q.float() / float(wd))[None, :]
    dx = (ridx % wd).float()[:, None] - (q % wd).float()[None, :]
    dist = dy * dy + dx * dx  # (P_loc, P)
    w = torch.exp(-dist[None] * torch.as_tensor(inv_sigma2, device=dev)[:, None, None])
    ew = e * w[None]
    hi = ew.to(bank_labels.dtype).float()
    ew = hi + (ew - hi).to(bank_labels.dtype).float()
    acc = torch.einsum("kbrd,bkrq->bdq", lab, ew)  # (B, D_pad, P)
    m = m[:, 0, 0, :]
    if return_stats:
        return m, l, acc
    return acc / torch.clamp(l, min=1e-30)[:, None, :]


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def affinity_from_bank_batched(
    bank_feats: torch.Tensor,
    bank_labels: torch.Tensor,
    target_feats: torch.Tensor,
    slots,
    *,
    feature_hw: Tuple[int, int],
    temperature: float,
    valid=None,
    dense=None,
    sigma_1: float = 8.0,
    sigma_2: float = 21.0,
    spatial: bool = True,
    row_base: int = 0,
    return_stats: bool = False,
):
    """B videos in lockstep, each reading its ring bank by slot index.

    Args:
      bank_feats: (capacity, B, P_loc, C) bank features (bf16 on the card).
      bank_labels: (capacity, B, P_loc, D_pad) labels, D_pad % 8 == 0.
      target_feats: (B, P, C) current-frame features (any float dtype; the
        temperature is applied in float32, then rounded to the bank dtype).
      slots: (K,) host ints, physical bank slots of the sampled frames
        (K ≤ 16); valid / dense: (K,) host bools.
      feature_hw: the GLOBAL feature grid (hd, wd), P = hd·wd.
      row_base: global row index of this bank's first row (bank shards).
      return_stats: return (m (B, P), l (B, P), acc (B, D_pad, P)), the raw
        online-softmax statistics, instead of acc / l.

    Returns:
      (B, D_pad, P) float32 scores (padded classes exactly 0), or the stats.
    """
    kw = dict(
        feature_hw=feature_hw, temperature=temperature, valid=valid, dense=dense,
        sigma_1=sigma_1, sigma_2=sigma_2, spatial=spatial, row_base=row_base,
        return_stats=return_stats,
    )
    dev = bank_feats.device
    if dev.type == "cpu":
        return affinity_from_bank_plain(bank_feats, bank_labels, target_feats, slots, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    cap, b, p_loc, c = bank_feats.shape
    d_pad = bank_labels.shape[-1]
    hd, wd = feature_hw
    p = hd * wd
    _check(bank_feats, "bank_feats", torch.bfloat16, 4, dev)
    _check(bank_labels, "bank_labels", torch.bfloat16, 4, dev)
    if bank_labels.shape[:3] != (cap, b, p_loc) or d_pad % 8:
        raise ValueError(f"bank_labels shape {tuple(bank_labels.shape)} does not match the bank")
    if c % 16:
        raise ValueError(f"feature width {c} must be a multiple of 16")
    if target_feats.shape != (b, p, c) or target_feats.device != dev:
        raise ValueError(f"target_feats must be ({b}, {p}, {c}) on {dev}, got {tuple(target_feats.shape)}")
    if p_loc < p and row_base == 0 and not return_stats:
        raise ValueError(f"bank holds {p_loc} rows < P={p}: only a shard may")
    slots, inv_sigma2, bias = slot_table(slots, valid, dense, sigma_1, sigma_2, spatial)
    k = slots.shape[0]
    if not 1 <= k <= MAX_SLOTS:
        raise ValueError(f"K={k} slots, the kernel takes 1..{MAX_SLOTS}")
    if slots.min() < 0 or slots.max() >= cap:
        raise ValueError(f"slots {slots.tolist()} outside the bank's {cap} slots")

    tgt = (target_feats.float() * temperature).to(torch.bfloat16).contiguous()
    out = torch.empty((b, d_pad, p), dtype=torch.float32, device=dev)
    if return_stats:
        m = torch.empty((b, p), dtype=torch.float32, device=dev)
        l = torch.empty((b, p), dtype=torch.float32, device=dev)
    from semi_supervised_vos_tpu_torch.ops._build import load

    lib = load("affinity_bank")
    fn = lib.affinity_bank_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    slots_c = (ctypes.c_int * k)(*slots.tolist())
    inv_c = (ctypes.c_float * k)(*inv_sigma2.tolist())
    bias_c = (ctypes.c_float * k)(*bias.tolist())
    err = fn(
        bank_feats.data_ptr(), bank_labels.data_ptr(), tgt.data_ptr(), out.data_ptr(),
        m.data_ptr() if return_stats else None, l.data_ptr() if return_stats else None,
        slots_c, inv_c, bias_c, k,
        b, p_loc, c, d_pad, p, wd, int(row_base), int(return_stats),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"affinity_bank kernel launch failed: cudaError {err}")
    affinity_from_bank_batched.launches += 1
    if return_stats:
        return m, l, out
    return out


affinity_from_bank_batched.launches = 0


def affinity_from_bank(bank_feats, bank_labels, target_feat, slots, **kw) -> torch.Tensor:
    """Single video: bank (capacity, P_pad, C) / (capacity, P_pad, D_pad),
    target (P, C) → (D_pad, P) float32 scores."""
    cap, p_pad, c = bank_feats.shape
    out = affinity_from_bank_batched(
        bank_feats.view(cap, 1, p_pad, c),
        bank_labels.view(cap, 1, p_pad, bank_labels.shape[-1]),
        target_feat[None],
        slots,
        **kw,
    )
    return out[0]


def affinity_from_bank_stats(bank_feats, bank_labels, target_feat, slots, *, row_base, **kw):
    """Per-shard statistics (m (P,), l (P,), acc (D_pad, P)) of a bank shard
    holding GLOBAL rows [row_base, row_base + P_loc); shards combine exactly
    as ``m* = max m;  out = Σ acc·exp(m−m*) / Σ l·exp(m−m*)``."""
    cap, p_loc, c = bank_feats.shape
    m, l, acc = affinity_from_bank_batched(
        bank_feats.view(cap, 1, p_loc, c),
        bank_labels.view(cap, 1, p_loc, bank_labels.shape[-1]),
        target_feat[None],
        slots,
        row_base=row_base,
        return_stats=True,
        **kw,
    )
    return m[0], l[0], acc[0]
