"""Fused affinity: the CUDA kernel's wrappers and their plain PyTorch
versions.

Ports of the two propagation kernels of
``semi_supervised_vos_tpu/ops/affinity_pallas.py``, both on the one kernel
``csrc/affinity_bank.cu`` (see its header for the design and what bounds
it), each with its own launch counter. The kernel splits the bank sweep
over blocks and a second kernel of the same source combines the partial
statistics (:func:`combine_partials`, plain version
:func:`combine_partials_plain`); one op call is one count. A float32 bank
(``SVOS_INFER_DTYPE=float32``) runs the bank sweep of
``csrc/affinity_bank_f32.cu`` instead (a float32-accurate similarity on
the tf32 tensor cores, 3xTF32; the same split plan and combine kernel),
counted apart in
``affinity_from_bank_batched.launches_f32``.

* ``affinity_from_bank_batched`` (and its ``affinity_from_bank`` /
  ``affinity_from_bank_stats`` wrappers): the engine's op, reading the ring
  bank by slot index;
* ``affinity_propagate_pallas`` → :func:`affinity_propagate_fused`: the
  same online softmax over a pre-gathered (K, P, C) reference set, launched
  as a one-video bank with slots 0..K−1.

Per target pixel, the K sampled slots stream straight from the ring bank by
slot index: similarity ``ref·(T·tgt)`` with −1e30 biases on padded rows and
invalid slots, an online softmax with an **unweighted** denominator, the
Gaussian prior ``exp(−((yᵣ−yₜ)²+(xᵣ−xₜ)²)·invσ²_slot)`` built from pixel
indices (``y = idx / wd`` fractional, rows offset by ``row_base``) and
applied after the softmax, and the label aggregation. invσ² = 0 is
probability mode.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -1e30
MAX_WIDTH = 256  # feature widths the kernels take (the bf16 kernel's target rows live in registers)
LABEL_GROUP = 64  # label columns per sweep of the bf16 kernel
LABEL_GROUP_F32 = 24  # of the float32 kernel: one sweep at the 22-class budget


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


def _launch_bank_kernel(bank_feats, bank_labels, tgt, slots, valid, dense, *, feature_hw, sigma_1, sigma_2,
                       spatial, row_base, return_stats, f32=False):
    """Check the arguments and launch the bank sweep on the current stream:
    ``csrc/affinity_bank.cu`` on a bf16 bank and target, or with ``f32``
    ``csrc/affinity_bank_f32.cu`` on a float32 bank and target (labels bf16
    in both); ``tgt`` is the (B, P, C) target with the temperature folded
    in. Returns the (B, D_pad, P) output, or (m, l, acc) in stats mode."""
    dev = bank_feats.device
    cap, b, p_loc, c = bank_feats.shape
    d_pad = bank_labels.shape[-1]
    hd, wd = feature_hw
    p = hd * wd
    feat_dtype = torch.float32 if f32 else torch.bfloat16
    _check(bank_feats, "bank_feats", feat_dtype, 4, dev)
    _check(bank_labels, "bank_labels", torch.bfloat16, 4, dev)
    _check(tgt, "target", feat_dtype, 3, dev)
    if bank_labels.shape[:3] != (cap, b, p_loc) or d_pad % 8:
        raise ValueError(f"bank_labels shape {tuple(bank_labels.shape)} does not match the bank")
    if c % 16 or c > MAX_WIDTH:
        raise ValueError(f"feature width {c} must be a multiple of 16 and at most {MAX_WIDTH}")
    if tgt.shape != (b, p, c):
        raise ValueError(f"target_feats must be ({b}, {p}, {c}), got {tuple(tgt.shape)}")
    if p_loc < p and row_base == 0 and not return_stats:
        raise ValueError(f"bank holds {p_loc} rows < P={p}: only a shard may")
    slots, inv_sigma2, bias = slot_table(slots, valid, dense, sigma_1, sigma_2, spatial)
    k = slots.shape[0]
    if k < 1:
        raise ValueError("no slots: the kernel takes K >= 1")
    if slots.min() < 0 or slots.max() >= cap:
        raise ValueError(f"slots {slots.tolist()} outside the bank's {cap} slots")
    # (3, K) int32 in device memory: slots, then the float32 bits of 1/sigma^2
    # and of the slot biases; copied from pinned memory without a host wait
    table = np.stack([slots, inv_sigma2.view(np.int32), bias.view(np.int32)])
    table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)

    name = "affinity_bank_f32" if f32 else "affinity_bank"
    lib = _library(name)
    group = LABEL_GROUP_F32 if f32 else LABEL_GROUP
    # the library's host code works on the current device (its shared-memory
    # attribute, SM count and occupancy, the launch itself): make it dev's
    with torch.cuda.device(dev):
        splits, ips = _plan(name, dev.index, k, b, p_loc, c, p, wd)
        # partial (m, l, acc) of each split of the bank sweep
        pm = torch.empty((splits, b, p), dtype=torch.float32, device=dev)
        pl = torch.empty_like(pm)
        pacc = torch.empty((splits, b, d_pad, p), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        sweep_launch = getattr(lib, f"{name}_launch")
        # label columns in groups of at most `group` per sweep
        for d_off in range(0, d_pad, group):
            err = sweep_launch(
                bank_feats.data_ptr(), bank_labels.data_ptr(), tgt.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                pacc.data_ptr(), table.data_ptr(), k, cap, b, p_loc, c, d_pad, d_off,
                min(group, d_pad - d_off), p, wd, int(row_base), splits, ips, stream,
            )
            if err != 0:
                raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    # both sweeps write float32 partials: one combine kernel
    return _launch_combine(_library(), pm, pl, pacc, return_stats)


def _library(name: str = "affinity_bank"):
    """The loaded library of ``csrc/<name>.cu`` (``affinity_bank`` or
    ``affinity_bank_f32``), its C signatures set."""
    from semi_supervised_vos_tpu_torch.ops._build import load

    lib = load(name)
    if not getattr(lib, "signatures_set", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        fns = [getattr(lib, f"{name}_plan"), getattr(lib, f"{name}_launch")]
        fns[0].argtypes = [i] * 6 + [ctypes.POINTER(i)] * 2
        fns[1].argtypes = [p] * 7 + [i] * 13 + [p]
        if name == "affinity_bank":
            lib.affinity_combine_launch.argtypes = [p] * 6 + [i] * 5 + [p]
            fns.append(lib.affinity_combine_launch)
        for fn in fns:
            fn.restype = i
        lib.signatures_set = True
    return lib


@functools.lru_cache(maxsize=64)
def _plan(name: str, device_index: int, k: int, b: int, p_loc: int, c: int, p: int, wd: int) -> Tuple[int, int]:
    """(splits, iterations per split) of a sweep of kernel ``name`` of this
    shape on this card."""
    splits, ips = ctypes.c_int(0), ctypes.c_int(0)
    bank_plan = getattr(_library(name), f"{name}_plan")
    with torch.cuda.device(device_index):
        err = bank_plan(k, b, p_loc, c, p, wd, ctypes.byref(splits), ctypes.byref(ips))
    if err != 0:
        raise RuntimeError(f"{name} plan failed: cudaError {err}")
    return splits.value, ips.value


def _launch_combine(lib, pm, pl, pacc, return_stats):
    """The combine kernel of ``csrc/affinity_bank.cu`` on (S, B, P) / (S, B,
    D_pad, P) partials: (B, D_pad, P) acc / l, or the combined (m, l, acc)."""
    s, b, d_pad, p = pacc.shape
    dev = pacc.device
    out = torch.empty((b, d_pad, p), dtype=torch.float32, device=dev)
    m = torch.empty((b, p), dtype=torch.float32, device=dev) if return_stats else None
    l = torch.empty((b, p), dtype=torch.float32, device=dev) if return_stats else None
    with torch.cuda.device(dev):
        err = lib.affinity_combine_launch(
            pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(), out.data_ptr(),
            m.data_ptr() if return_stats else None, l.data_ptr() if return_stats else None,
            s, b, p, d_pad, int(return_stats), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"affinity_combine kernel launch failed: cudaError {err}")
    return (m, l, out) if return_stats else out


def combine_partials_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *, return_stats: bool = False):
    """Plain PyTorch version of the combine kernel: partial online-softmax
    statistics m (S, B, P), l (S, B, P), acc (S, B, D_pad, P) of S parts of
    the bank sweep (slot groups or row ranges) → the unsplit (B, D_pad, P)
    acc / l, or (m, l, acc) in stats mode, at float32:
    ``m* = max m;  out = Σ acc·exp(m−m*) / Σ l·exp(m−m*)``."""
    m_star = m.amax(dim=0)
    w = torch.exp(m - m_star)
    l_sum = (l * w).sum(dim=0)
    acc_sum = (acc * w[:, :, None, :]).sum(dim=0)
    if return_stats:
        return m_star, l_sum, acc_sum
    return acc_sum / torch.clamp(l_sum, min=1e-30)[:, None, :]


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, *, return_stats: bool = False):
    """The bank sweep's combine step on its own (arguments and results as
    :func:`combine_partials_plain`): the plain version on a CPU tensor, the
    combine kernel of ``csrc/affinity_bank.cu`` on a CUDA tensor. The
    affinity ops run it inside each call; it has no launch counter of its
    own."""
    dev = m.device
    if dev.type == "cpu":
        return combine_partials_plain(m, l, acc, return_stats=return_stats)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    s, b, d_pad, p = acc.shape
    for name, t, shape in (("m", m, (s, b, p)), ("l", l, (s, b, p)), ("acc", acc, (s, b, d_pad, p))):
        _check(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return _launch_combine(_library(), m, l, acc, return_stats)


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
      bank_feats: (capacity, B, P_loc, C) bank features (bf16 or float32 on
        the card: the float32 kernel runs on a float32 bank).
      bank_labels: (capacity, B, P_loc, D_pad) labels, D_pad % 8 == 0 (bf16
        on the card).
      target_feats: (B, P, C) current-frame features (any float dtype; the
        temperature is applied in float32, then rounded to the bank dtype).
      slots: (K,) host ints, physical bank slots of the sampled frames (any
        K >= 1); valid / dense: (K,) host bools.
      feature_hw: the GLOBAL feature grid (hd, wd), P = hd·wd.
      row_base: global row index of this bank's first row (bank shards).
      return_stats: return (m (B, P), l (B, P), acc (B, D_pad, P)), the raw
        online-softmax statistics, instead of acc / l.

    Returns:
      (B, D_pad, P) float32 scores (padded classes exactly 0), or the stats.
    """
    kw = dict(
        feature_hw=feature_hw, valid=valid, dense=dense, sigma_1=sigma_1, sigma_2=sigma_2,
        spatial=spatial, row_base=row_base, return_stats=return_stats,
    )
    dev = bank_feats.device
    if dev.type == "cpu":
        return affinity_from_bank_plain(bank_feats, bank_labels, target_feats, slots, temperature=temperature, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if target_feats.device != dev:
        raise ValueError(f"target_feats is on {target_feats.device}, expected {dev}")
    if bank_feats.dtype == torch.float32:
        tgt = (target_feats.float() * temperature).contiguous()
        out = _launch_bank_kernel(bank_feats, bank_labels, tgt, slots, f32=True, **kw)
        affinity_from_bank_batched.launches_f32 += 1
        return out
    tgt = (target_feats.float() * temperature).to(torch.bfloat16).contiguous()
    out = _launch_bank_kernel(bank_feats, bank_labels, tgt, slots, **kw)
    affinity_from_bank_batched.launches += 1
    return out


affinity_from_bank_batched.launches = 0  # csrc/affinity_bank.cu
affinity_from_bank_batched.launches_f32 = 0  # csrc/affinity_bank_f32.cu


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


# ---- the propagation over a pre-gathered reference set --------------------


def _gathered_bank(ref_feats, target_feat, ref_labels, feature_hw, temperature, label_dtype):
    """The gathered set as a one-video bank for ``csrc/affinity_bank.cu``,
    with the TPU kernel's roundings: the temperature folded into ``ref`` in
    float32 before the bf16 rounding, the target rounded to bf16, and the
    labels rounded to ``label_dtype``. Float32 labels become a bf16 ``hi``
    and ``lo`` half of one 2·D_pad-wide label block (the output is linear in
    the labels, so the two output halves sum to the float32-label result to
    ~16 bits). C is zero-padded to a multiple of 16, D to one of 8.

    Returns (bank (K, 1, P, C16) bf16, labels (K, 1, P, D_pad or 2·D_pad)
    bf16, target (1, P, C16) bf16, D_pad)."""
    if label_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"label_dtype must be torch.bfloat16 or torch.float32, got {label_dtype}")
    k, p, c = ref_feats.shape
    d = ref_labels.shape[-1]
    if target_feat.shape != (p, c) or ref_labels.shape[:2] != (k, p) or feature_hw[0] * feature_hw[1] != p:
        raise ValueError(
            f"shapes do not match: ref {tuple(ref_feats.shape)}, target {tuple(target_feat.shape)}, "
            f"labels {tuple(ref_labels.shape)}, feature_hw {tuple(feature_hw)}"
        )
    c_pad, d_pad = -(-c // 16) * 16, -(-d // 8) * 8
    pad_c = torch.nn.functional.pad
    ref = pad_c((ref_feats.float() * temperature).to(torch.bfloat16), (0, c_pad - c))
    tgt = pad_c(target_feat.to(torch.bfloat16), (0, c_pad - c))
    lab = pad_c(ref_labels.float(), (0, d_pad - d))
    hi = lab.to(torch.bfloat16)
    if label_dtype == torch.float32:
        hi = torch.cat([hi, (lab - hi.float()).to(torch.bfloat16)], dim=-1)
    return ref[:, None].contiguous(), hi[:, None].contiguous(), tgt[None].contiguous(), d_pad


def _fold_halves(out: torch.Tensor, d: int, d_pad: int) -> torch.Tensor:
    """(1, D_pad or 2·D_pad, P) kernel output → (D, P): the hi and lo label
    halves summed."""
    out = out[0]
    if out.shape[0] == d_pad:
        return out[:d]
    return out[:d] + out[d_pad : d_pad + d]


def affinity_propagate_fused_plain(
    ref_feats: torch.Tensor,
    target_feat: torch.Tensor,
    ref_labels: torch.Tensor,
    *,
    feature_hw: Tuple[int, int],
    temperature: float,
    valid=None,
    dense=None,
    sigma_1: float = 8.0,
    sigma_2: float = 21.0,
    spatial: bool = True,
    label_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`affinity_propagate_fused`: the card
    path's roundings (:func:`_gathered_bank`) and then
    :func:`affinity_from_bank_plain` over slots 0..K−1, on any device."""
    d = ref_labels.shape[-1]
    bank, labels, tgt, d_pad = _gathered_bank(ref_feats, target_feat, ref_labels, feature_hw, temperature, label_dtype)
    out = affinity_from_bank_plain(
        bank, labels, tgt, np.arange(bank.shape[0]), feature_hw=feature_hw, temperature=1.0,
        valid=valid, dense=dense, sigma_1=sigma_1, sigma_2=sigma_2, spatial=spatial,
    )
    return _fold_halves(out, d, d_pad)


def affinity_propagate_fused(
    ref_feats: torch.Tensor,
    target_feat: torch.Tensor,
    ref_labels: torch.Tensor,
    *,
    feature_hw: Tuple[int, int],
    temperature: float,
    valid=None,
    dense=None,
    sigma_1: float = 8.0,
    sigma_2: float = 21.0,
    spatial: bool = True,
    label_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Fused drop-in for :func:`core.propagation.affinity_propagate`: the
    port of ``semi_supervised_vos_tpu/ops/affinity_pallas.py::
    affinity_propagate_pallas``.

    Args:
      ref_feats: (K, P, C) sampled reference features (any float dtype).
      target_feat: (P, C) target features.
      ref_labels: (K, P, D) label distribution.
      feature_hw: (hd, wd) with hd·wd == P.
      valid / dense: (K,) host bools (see ``core.sampling.sample_frames``).
      spatial: False is probability propagation (no spatial prior).
      label_dtype: torch.bfloat16 (the default) or torch.float32 labels.

    Returns:
      (D, P) float32 scores.

    On a CPU tensor it runs :func:`affinity_propagate_fused_plain`. On a CUDA
    tensor it launches ``csrc/affinity_bank.cu`` over the gathered set seen
    as a one-video bank with slots 0..K−1 and temperature 1 (the function is
    the same online softmax), or raises. That kernel also skips (bank tile,
    target tile) pairs whose prior is below exp(−36), which the TPU kernel
    does not; the skipped rows move a score by less than 2.3e-16.
    """
    kw = dict(feature_hw=feature_hw, temperature=temperature, valid=valid, dense=dense,
              sigma_1=sigma_1, sigma_2=sigma_2, spatial=spatial, label_dtype=label_dtype)
    dev = ref_feats.device
    if dev.type == "cpu":
        return affinity_propagate_fused_plain(ref_feats, target_feat, ref_labels, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("target_feat", target_feat), ("ref_labels", ref_labels)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    d = ref_labels.shape[-1]
    bank, labels, tgt, d_pad = _gathered_bank(ref_feats, target_feat, ref_labels, feature_hw, temperature, label_dtype)
    out = _launch_bank_kernel(
        bank, labels, tgt, np.arange(bank.shape[0]), valid, dense, feature_hw=feature_hw,
        sigma_1=sigma_1, sigma_2=sigma_2, spatial=spatial, row_base=0, return_stats=False,
    )
    affinity_propagate_fused.launches += 1
    return _fold_halves(out, d, d_pad)


affinity_propagate_fused.launches = 0
