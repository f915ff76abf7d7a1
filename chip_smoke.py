"""On-card smoke test of the PyTorch / CUDA port (one NVIDIA Hopper card).

    python3 chip_smoke.py

Phases, each printed as it runs (any failure exits non-zero, and the final
``{"ok": true, ...}`` line is printed only when every phase passed):

  1. device: the card's name and power limit, compute capability (9, 0),
     and the build of every CUDA kernel of the main path (nvcc, sm_90a),
     with ptxas's register and spill lines;
  2. the bank-affinity kernel against its plain float32 version: the
     16x20-grid numerics recipe (single video, two lockstep videos, two
     row_base shards in stats mode, combined), a ragged P, K = 1, one valid
     slot of nine, C 16 and 32, two videos at 480p, the combine kernel
     against its plain version, and the 480p shape, timed;
  3. ``affinity_propagate_fused`` (the propagation over a gathered
     reference set) against its plain version on the recipes of
     ``tests/test_pallas_affinity.py``, the 16x20 grid and the 480p shape
     (also with float32 labels, a 48-wide label block), timed; K = 20 slots
     through both affinity entry points;
  4. probability mode (no spatial prior) at 480p: both affinity ops timed
     beside ``scaled_dot_product_attention``, which computes the same
     function there, and checked against it; two lockstep videos;
  5. the fused bottleneck kernel against its plain float32 version at both
     480p geometries (C/C4 512/128 and 1024/256), N = 1 and 8, timed beside
     three cuDNN convolutions doing the same block; the strategies' 69x123
     and 54x97 grids and partial batches (N = 3), checked;
  6. the BN-folded bf16 resnet50 encoder (11 bottleneck launches) against
     the unfolded float32 module on one 480x854 frame;
  7. the main path: ``inference`` (default device) then ``evaluation`` on a
     synthetic 480p DAVIS tree with random resnet50 weights; the launch
     counters show that every frame went through both kernels; the card's
     masks are held against the CPU engine's on a small clip; the same
     tree again with ``-n 20``;
  8. ``affinity_propagate_fused``'s own path: a video propagated through it
     frame by frame, as a user of the library op would, against the
     engine's masks;
  9. the strategies: all seven through the CLI at 480p, ``--probability``
     with ``single`` and with ``hor-flip`` under each ``--fusion``, each
     with its launch counts, J&F and frames/s; card masks against the CPU
     engine's on a small clip for probability mode and hor-flip;
 10. the lockstep engine (``--video-batch``): (a) ``--video-batch 8`` then
     ``evaluation`` on 8 videos of 17 and 12 frames, one bank-kernel launch
     per lockstep step, masks and frames/s against ``--video-batch 1``;
     (b) every lockstep runner at ``--video-batch 2`` on two videos, launch
     counts and masks against ``--video-batch 1``; (c) device ms per
     lane-frame at B = 1 to 16, the bank kernel at B = 8 and 16 against its
     plain version (timed at B = 8 against its bound, and beside
     ``scaled_dot_product_attention`` in probability mode), the bottleneck
     at N = 64; (d) device memory of one chunk at 480p and 1080p, and one
     chunk at the lane cap under 85 % of the card's memory;
 11. training, on a 480p tree of 4 videos x 20 frames, at PyTorch's default
     precision (cuDNN TF32 convolutions, float32 matmuls): (a) the train step
     at full width (resnet50, bs 16 x 10 frames x 256^2) for cross-entropy,
     focal, contrastive, triplet with the default, temporal and skeleton
     (pipelined) miners and cross-entropy under ``--bf16``, device ms per
     step, peak memory, losses finite, and cross-entropy falling over 20
     steps on one batch; (b) ``train`` through the CLI (default device, 2
     epochs, ``--early-stop``), ``validation`` on its checkpoints, then
     ``inference`` and ``evaluation`` with the last one, clips/s and J&F;
     no hand-written kernel launches on the training path; (c) one resnet18
     step on the card against the CPU with TF32 off;
 12. facebook (2048-wide layer4, a two-conv head) at full width: (a) its
     encoder against the float32 module (8 bottleneck launches), and both
     TF32 flags left True by a single and a lockstep engine's step; (b)
     ``inference --model facebook`` then ``evaluation`` on the main path's
     tree, device ms per frame, card vs CPU masks on the small clip; (c)
     ``multimodel`` with facebook as the second network; (d) one lockstep
     chunk at facebook's lane cap at 480p and 1080p under 85 % of the card;
     (e) one cross-entropy train step at bs 16 x 10 frames x 256^2.

Times are medians of 20 CUDA-event timings, printed with their p10-p90
spread. The line before the last is the card's name and power limit as
nvidia-smi reports them, the one before that a JSON summary of every
kernel, and before that JSON lines for the strategies, the lockstep phase,
training and facebook.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
MUFU_EXP_PER_CLOCK_PER_SM = 16  # ex2 results per clock per SM on compute capability 9.0
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
AFFINITY_GATE = 3.4e-5  # max_abs of the bank kernel vs float32 (JAX on-chip gate)
STATS_GATE = 3.2e-5  # combined stats shards vs float32 (JAX on-chip gate)
# scaled_dot_product_attention returns bf16: half an ulp at 1.0 is 2e-3, and
# it rounds the softmax weights to bf16 before their product with the labels
SDPA_GATE = 4e-3
ENCODER_MIN_COS = 0.9999
# fused-bottleneck launches per encode call: the stride-1 blocks of 512 to
# 1024 channels without a downsample branch (models/infer_fast.py)
BOTTLENECK_LAUNCHES = {"resnet50": 11, "facebook": 8}
H480, W480 = 480, 854
H1080, W1080 = 1080, 1920
SMALL_CLIP = (120, 214, 12)  # h, w, frames of the card-vs-CPU mask checks
STRATEGY_FRAMES = 17  # 16 propagated frames: two whole chunks, past frame 15's dense/sparse switch


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()


def stage(name: str) -> None:
    """Mark a phase's start with the seconds since the script started."""
    log(f"== {name} (at {time.perf_counter() - START:.1f} s)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timing(float):
    """Median ms of a timing, carrying the spread of its reps (``lo`` and
    ``hi``: the 10th and 90th percentiles)."""

    def __new__(cls, times):
        times = sorted(times)
        self = super().__new__(cls, statistics.median(times))
        pick = lambda f: times[min(len(times) - 1, int(round(f * (len(times) - 1))))]  # noqa: E731
        self.lo, self.hi = pick(0.1), pick(0.9)
        return self

    def __format__(self, spec):
        return f"{float(self):{spec}} [p10 {self.lo:{spec}}, p90 {self.hi:{spec}}]"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> Timing:
    """Median of ``reps`` CUDA-event timings of ``fn``, with their p10-p90
    spread."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(times)


def timing_keys(prefix: str, t: Timing) -> dict:
    return {prefix: float(t), f"{prefix}_p10": t.lo, f"{prefix}_p90": t.hi}


def mufu_exp_rate() -> float:
    """exps per second of the card's MUFU pipe: MUFU_EXP_PER_CLOCK_PER_SM x
    SMs x the maximum SM clock that nvidia-smi reports."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return MUFU_EXP_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def bound(tensor_ops: float, nbytes: float, exps: float = 0.0):
    """Least time (ms) for the work, and what sets it: the largest of the
    bf16 tensor-core operations at their peak rate, the exps at the MUFU
    pipe's rate (both "operations") and the bytes at the memory rate."""
    t_tensor = tensor_ops / PEAK_BF16_FLOPS * 1e3
    t_exp = exps / mufu_exp_rate() * 1e3 if exps else 0.0
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(t_tensor, t_exp)
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


def affinity_bound(torch, dev, k, p, wd, c, d, inv_sigma2, nbytes):
    """Least time (ms) of one propagation of a P-pixel frame over K slots,
    counting the work this frame's data needs: the similarity (2·K·P²·C)
    and the softmax exp of every pair; the label product (2·D a pair) where
    the prior is not below exp(-36), which is every pair in probability
    mode (inverse sigma² 0); the prior factored into a row and a column
    factor, 2·P − 1 + 2·wd − 1 exps for each slot that has one."""
    y = torch.arange(p, device=dev, dtype=torch.float32) / wd
    dy2 = (y[:, None] - y[None, :]) ** 2
    near = [int((dy2 * float(s) < 36.0).sum()) for s in inv_sigma2]
    ops = 2.0 * k * p * p * c + 2.0 * sum(near) * d
    exps = k * p * p + sum(2 * p - 1 + 2 * wd - 1 for s in inv_sigma2 if s > 0)
    return bound(ops, nbytes, exps)


# ---- phase 2: affinity ---------------------------------------------------


def affinity_phase(torch, dev, rng):
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    c, d, d_pad, cap, k, frame_idx = 256, 22, 24, 45, 9, 50
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    slots = idx % cap

    def make_bank(p, b=1, c=c):
        feats = torch.as_tensor(rng.standard_normal((cap, b, p, c)) * 0.2, dtype=torch.float32)
        cls = torch.as_tensor(rng.integers(0, d, size=(cap, b, p)))
        labels = torch.nn.functional.one_hot(cls, d_pad).float()
        tgt = torch.as_tensor(rng.standard_normal((b, p, c)) * 0.2, dtype=torch.float32)
        # the target holds bf16 values, as the encoder emits them on the main path
        return feats.to(dev, torch.bfloat16), labels.to(dev, torch.bfloat16), tgt.to(dev, torch.bfloat16).float()

    def compare(got, expect):
        got, expect = got[..., :d, :], expect[..., :d, :]
        max_abs = (got - expect).abs().max().item()
        agree = (got.argmax(-2) == expect.argmax(-2)).double().mean().item()
        return max_abs, agree

    res = {}
    hd, wd = 16, 20
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    bf, bl, tgt = make_bank(hd * wd)
    got = aff.affinity_from_bank_batched(bf, bl, tgt, slots, **kw)
    expect = aff.affinity_from_bank_plain(bf.float(), bl.float(), tgt, slots, **kw)
    max_abs, agree = compare(got, expect)
    log(f"affinity (a) 16x20 single: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= AFFINITY_GATE and agree == 1.0, f"affinity single <= {AFFINITY_GATE} / 1.0")

    # (b) two lockstep lanes: lane 1 is (a), lane 0 independent
    bf0, bl0, tgt0 = make_bank(hd * wd)
    bfb, blb, tgtb = (torch.cat([x0, x1], dim=1 if x0.ndim == 4 else 0).contiguous()
                      for x0, x1 in ((bf0, bf), (bl0, bl), (tgt0, tgt)))
    got = aff.affinity_from_bank_batched(bfb, blb, tgtb, slots, **kw)
    expect = aff.affinity_from_bank_plain(bfb.float(), blb.float(), tgtb, slots, **kw)
    max_abs, agree = compare(got, expect)
    log(f"affinity (b) 16x20 B=2: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= AFFINITY_GATE and agree == 1.0, f"affinity B=2 <= {AFFINITY_GATE} / 1.0")

    # (c) stats mode over two row_base shards, combined
    p, p_loc = hd * wd, hd * wd // 2
    stats = []
    for s in range(2):
        rows = slice(s * p_loc, (s + 1) * p_loc)
        stats.append(aff.affinity_from_bank_stats(
            bf[:, 0, rows].contiguous(), bl[:, 0, rows].contiguous(), tgt[0], slots,
            row_base=s * p_loc, **kw))
    (m0, l0, a0), (m1, l1, a1) = stats
    m_g = torch.maximum(m0, m1)
    s0, s1 = torch.exp(m0 - m_g), torch.exp(m1 - m_g)
    combined = (a0 * s0 + a1 * s1) / torch.clamp(l0 * s0 + l1 * s1, min=1e-30)
    expect = aff.affinity_from_bank_plain(bf.float(), bl.float(), tgt, slots, **kw)[0]
    max_abs, agree = compare(combined, expect)
    log(f"affinity (c) 16x20 stats shards: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= STATS_GATE and agree == 1.0, f"affinity stats shards <= {STATS_GATE} / 1.0")

    # (e) the shapes the split design makes risky: a ragged P, K = 1, one
    # valid slot of nine, C 16 and 32, two lockstep videos at 480p
    one_valid = np.zeros(k, bool)
    one_valid[k // 2] = True
    extra = [("13x27 ragged P", (13, 27), 1, c, slots, valid, dense),
             ("K=1", (16, 20), 1, c, slots[:1], np.ones(1, bool), np.ones(1, bool)),
             ("one valid slot of nine", (16, 20), 1, c, slots, one_valid, dense),
             ("C=16", (16, 20), 1, 16, slots, valid, dense),
             ("C=32", (16, 20), 1, 32, slots, valid, dense),
             ("480p B=2", (60, 107), 2, c, slots, valid, dense)]
    for name, (eh, ew), eb, ec, eslots, evalid, edense in extra:
        ekw = dict(feature_hw=(eh, ew), temperature=1.0, valid=evalid, dense=edense)
        bf_e, bl_e, tgt_e = make_bank(eh * ew, eb, ec)
        got = aff.affinity_from_bank_batched(bf_e, bl_e, tgt_e, eslots, **ekw)
        expect = aff.affinity_from_bank_plain(bf_e.float(), bl_e.float(), tgt_e, eslots, **ekw)
        max_abs, agree = compare(got, expect)
        min_agree = 0.999 if eh == 60 else 1.0
        log(f"affinity (e) {name}: max_abs={max_abs:.3e} argmax_agreement={agree}")
        check(max_abs <= AFFINITY_GATE and agree >= min_agree, f"affinity {name} <= {AFFINITY_GATE} / {min_agree}")
        check(bool((got[:, d:] == 0).all()), f"affinity {name}: padded classes exactly 0")

    # (f) the combine kernel against its plain version, one part all invalid
    sp, bp, pp = 5, 2, 351
    pm = torch.as_tensor(rng.standard_normal((sp, bp, pp)) * 3, dtype=torch.float32, device=dev)
    pm[1] = -1e30
    pl = torch.as_tensor(rng.uniform(0.5, 50, (sp, bp, pp)), dtype=torch.float32, device=dev)
    pacc = torch.as_tensor(rng.uniform(0, 1, (sp, bp, d_pad, pp)), dtype=torch.float32, device=dev) * pl[:, :, None]
    for stats in (False, True):
        got = aff.combine_partials(pm, pl, pacc, return_stats=stats)
        expect = aff.combine_partials_plain(pm, pl, pacc, return_stats=stats)
        got, expect = (got, expect) if stats else ((got,), (expect,))
        rel = max(((g - e).abs().max() / e.abs().max()).item() for g, e in zip(got, expect))
        log(f"affinity (f) combine kernel, stats={stats}: max_abs/max_ref={rel:.3e}")
        check(rel <= 1e-6, f"combine kernel stats={stats} vs plain <= 1e-6 relative")

    # (d) the 480p shape (60 x 107 feature grid), timed
    hd, wd = 60, 107
    p = hd * wd
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    bf, bl, tgt = make_bank(p)
    bank, labels, target = bf[:, 0], bl[:, 0], tgt[0]
    run_kernel = lambda: aff.affinity_from_bank(bank, labels, target, slots, **kw)  # noqa: E731
    bf32, bl32 = bf.float(), bl.float()
    run_plain = lambda: aff.affinity_from_bank_plain(bf32, bl32, tgt, slots, **kw)  # noqa: E731
    max_abs, agree = compare(run_kernel(), run_plain()[0])
    log(f"affinity (d) 480p 60x107: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= AFFINITY_GATE and agree >= 0.999, f"affinity 480p <= {AFFINITY_GATE} / 0.999")
    ms = time_ms(run_kernel)
    plain_ms = time_ms(run_plain)
    _, inv_sigma2, _ = aff.slot_table(slots, valid, dense, 8.0, 21.0, True)
    nbytes = k * p * (c + d_pad) * 2 + p * c * 4 + d_pad * p * 4
    b_ms, b_by = affinity_bound(torch, dev, k, p, wd, c, d, inv_sigma2, nbytes)
    log(f"affinity 480p: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    res.update(max_abs_err=max_abs, **timing_keys("ms", ms), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    return res


# ---- phase 3: the propagation over a gathered set -------------------------


def propagate_phase(torch, dev, rng):
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    d = 22

    def inputs(k, hd, wd, c, std, n_cls, soft=False):
        p = hd * wd
        ref = torch.as_tensor(rng.standard_normal((k, p, c)) * std, dtype=torch.float32, device=dev)
        tgt = torch.as_tensor(rng.standard_normal((p, c)) * std, dtype=torch.float32, device=dev)
        if soft:
            lab = torch.as_tensor(rng.dirichlet(np.ones(d), size=(k, p)), dtype=torch.float32, device=dev)
        else:
            lab = torch.nn.functional.one_hot(torch.as_tensor(rng.integers(0, n_cls, size=(k, p))), d)
            lab = lab.float().to(dev)
        return ref, tgt, lab

    def compare(name, got, expect, min_agree=1.0):
        max_abs = (got - expect).abs().max().item()
        agree = (got.argmax(0) == expect.argmax(0)).double().mean().item()
        log(f"propagate {name}: max_abs={max_abs:.3e} argmax_agreement={agree}")
        check(max_abs <= AFFINITY_GATE and agree >= min_agree, f"propagate {name} <= {AFFINITY_GATE} / {min_agree}")
        return max_abs

    worst = 0.0
    # the recipes of tests/test_pallas_affinity.py
    recipes = [(f"6x8 T1.9 frame {t} spatial {sp}", (9, 6, 8, 32, t, 1.9, sp, False))
               for t in (3, 9, 20) for sp in (True, False)]
    recipes += [("4x8 float32 labels", (4, 4, 8, 16, 4, 1.0, True, True)),
                ("5x7 padded", (3, 5, 7, 16, 3, 1.0, True, False))]
    for name, (k, hd, wd, c, t, temp, spatial, f32) in recipes:
        ref, tgt, lab = inputs(k, hd, wd, c, 0.3, 5, soft=f32)
        _, valid, dense = sample_frames(t, 40, k)
        if f32:
            dense = np.ones(k, bool)
        kw = dict(feature_hw=(hd, wd), temperature=temp, valid=valid, dense=dense, spatial=spatial,
                  label_dtype=torch.float32 if f32 else torch.bfloat16)
        worst = max(worst, compare(name, aff.affinity_propagate_fused(ref, tgt, lab, **kw),
                                   aff.affinity_propagate_fused_plain(ref, tgt, lab, **kw)))

    k, c, cap = 9, 256, 45
    idx, valid, dense = sample_frames(50, 40, k)
    hd, wd = 16, 20
    ref, tgt, lab = inputs(k, hd, wd, c, 0.2, d)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    worst = max(worst, compare("16x20", aff.affinity_propagate_fused(ref, tgt, lab, **kw),
                               aff.affinity_propagate_fused_plain(ref, tgt, lab, **kw)))

    # K = 20 slots through both entry points (inference -n 20), all valid
    idx20, valid20, dense20 = sample_frames(40, 40, 20)
    kw20 = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid20, dense=dense20)
    bank = torch.as_tensor(rng.standard_normal((cap, hd * wd, c)) * 0.2, dtype=torch.float32).to(dev, torch.bfloat16)
    cls = torch.as_tensor(rng.integers(0, d, size=(cap, hd * wd)))
    blab = torch.nn.functional.one_hot(cls, 24).to(dev, torch.bfloat16)
    btgt = tgt.to(torch.bfloat16).float()
    slots20 = idx20 % cap
    got = aff.affinity_from_bank(bank, blab, btgt, slots20, **kw20)[:d]
    expect = aff.affinity_from_bank_plain(bank[:, None].float(), blab[:, None].float(), btgt[None], slots20, **kw20)
    worst = max(worst, compare("K=20 affinity_from_bank", got, expect[0, :d]))
    sel = torch.as_tensor(slots20, device=dev)
    args20 = (bank[sel], btgt, blab[sel][..., :d])
    worst = max(worst, compare("K=20 affinity_propagate_fused", aff.affinity_propagate_fused(*args20, **kw20),
                               aff.affinity_propagate_fused_plain(*args20, **kw20)))

    # the 480p shape, timed
    hd, wd = 60, 107
    p = hd * wd
    ref, tgt, lab = inputs(k, hd, wd, c, 0.2, d)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    run_kernel = lambda: aff.affinity_propagate_fused(ref, tgt, lab, **kw)  # noqa: E731
    run_plain = lambda: aff.affinity_propagate_fused_plain(ref, tgt, lab, **kw)  # noqa: E731
    worst = max(worst, compare("480p 60x107", run_kernel(), run_plain(), min_agree=0.999))
    # float32 labels at 480p: a 2·D_pad = 48-wide label block; soft labels
    # with one dominant class, so both bf16 halves carry weight
    soft = torch.as_tensor(rng.dirichlet(np.ones(d), size=(k, p)), dtype=torch.float32, device=dev)
    lab48 = 0.6 * lab + 0.4 * soft
    kw48 = dict(kw, label_dtype=torch.float32)
    worst = max(worst, compare("480p float32 labels (D_pad 48)", aff.affinity_propagate_fused(ref, tgt, lab48, **kw48),
                               aff.affinity_propagate_fused_plain(ref, tgt, lab48, **kw48), min_agree=0.999))
    ms = time_ms(run_kernel)
    plain_ms = time_ms(run_plain)
    _, inv_sigma2, _ = aff.slot_table(np.arange(k), valid, dense, 8.0, 21.0, True)
    nbytes = (k * p * (c + d) + p * c) * 4 + d * p * 4  # float32 ref, labels and target in; scores out
    b_ms, b_by = affinity_bound(torch, dev, k, p, wd, c, d, inv_sigma2, nbytes)
    log(f"propagate 480p: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(max_abs_err=worst, **timing_keys("ms", ms), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# ---- phase 4: probability mode beside scaled_dot_product_attention ---------


def probability_phase(torch, dev, rng):
    """At 480p with the prior off, one attention call computes the same
    function: queries the target pixels, keys the K·P sampled bank rows (the
    temperature, 1 here, would scale them), values their labels; the invalid
    slots a -inf mask would drop are left out of the keys (none at frame
    50). The keys and values are gathered before the timed call."""
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    c, d, d_pad, cap, k, hd, wd = 256, 22, 24, 45, 9, 60, 107
    p = hd * wd
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    bank = torch.as_tensor(rng.standard_normal((cap, p, c)) * 0.2, dtype=torch.float32).to(dev, torch.bfloat16)
    cls = torch.as_tensor(rng.integers(0, d, size=(cap, p)))
    labels = torch.nn.functional.one_hot(cls, d_pad).to(dev, torch.bfloat16)
    tgt = torch.as_tensor(rng.standard_normal((p, c)) * 0.2, dtype=torch.float32).to(dev, torch.bfloat16)
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, spatial=False)
    sel = torch.as_tensor(slots[valid], device=dev)
    ref, ref_lab = bank[sel].contiguous(), labels[sel][..., :d].contiguous()
    q = tgt[None, None]
    keys = bank[sel].reshape(1, 1, -1, c)
    values = labels[sel].reshape(1, 1, -1, d_pad)
    tgt32 = tgt.float()

    run_bank = lambda: aff.affinity_from_bank(bank, labels, tgt32, slots, **kw)  # noqa: E731
    run_fused = lambda: aff.affinity_propagate_fused(ref, tgt, ref_lab, **kw)  # noqa: E731
    run_library = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)  # noqa: E731
    expect = aff.affinity_from_bank_plain(bank[:, None].float(), labels[:, None].float(), tgt32[None], slots,
                                          **kw)[0, :d]
    res = {}
    for name, got in (("affinity_bank", run_bank()[:d]), ("affinity_propagate", run_fused()),
                      ("scaled_dot_product_attention", run_library()[0, 0, :, :d].float().T)):
        max_abs = (got - expect).abs().max().item()
        gate = SDPA_GATE if name == "scaled_dot_product_attention" else AFFINITY_GATE
        log(f"probability mode 480p {name} vs plain float32: max_abs={max_abs:.3e}")
        check(max_abs <= gate, f"probability mode {name} <= {gate}")
    # two lockstep videos at 480p, prior off
    bank2 = torch.stack([bank, bank.roll(1, dims=1)], dim=1).contiguous()
    labels2 = torch.stack([labels, labels.roll(1, dims=1)], dim=1).contiguous()
    tgt2 = torch.stack([tgt32, tgt32.flip(0)])
    got2 = aff.affinity_from_bank_batched(bank2, labels2, tgt2, slots, **kw)[:, :d]
    expect2 = aff.affinity_from_bank_plain(bank2.float(), labels2.float(), tgt2, slots, **kw)[:, :d]
    max_abs = (got2 - expect2).abs().max().item()
    agree = (got2.argmax(1) == expect2.argmax(1)).double().mean().item()
    log(f"probability mode 480p B=2 vs plain float32: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= AFFINITY_GATE and agree >= 0.999, f"probability mode B=2 <= {AFFINITY_GATE} / 0.999")
    res["bank_ms"] = time_ms(run_bank)
    res["fused_ms"] = time_ms(run_fused)
    res["library_ms"] = time_ms(run_library)
    nbytes = k * p * (c + d_pad) * 2 + p * c * 2 + d_pad * p * 4
    res["bound_ms"], res["bound_by"] = affinity_bound(torch, dev, k, p, wd, c, d, np.zeros(k), nbytes)
    log(f"probability mode 480p: affinity_bank {res['bank_ms']:.4f} ms, affinity_propagate {res['fused_ms']:.4f} ms, "
        f"scaled_dot_product_attention {res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}); "
        f"affinity_bank / library {res['bank_ms'] / res['library_ms']:.3f}, "
        f"affinity_propagate / library {res['fused_ms'] / res['library_ms']:.3f}")
    return res


# ---- phase 5: bottleneck -------------------------------------------------


def bottleneck_phase(torch, dev, rng):
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block, bottleneck_block_plain

    def library_block(x, k1, b1, k2, b2, k3, b3):
        y = torch.relu(F.conv2d(x, k1, b1))
        y = torch.relu(F.conv2d(y, k2, b2, padding=1))
        return torch.relu(F.conv2d(y, k3, b3) + x)

    per_geom = {}
    worst = 0.0
    for c, c4 in ((512, 128), (1024, 256)):
        for n in (1, 8):
            h, w = 60, 107
            x = torch.as_tensor(rng.standard_normal((n, h, w, c)), dtype=torch.float32).to(dev, torch.bfloat16)
            wts = [
                torch.as_tensor(rng.standard_normal((c, c4)) * math.sqrt(2 / c), dtype=torch.float32),
                torch.as_tensor(rng.standard_normal(c4) * 0.1, dtype=torch.float32),
                torch.as_tensor(rng.standard_normal((3, 3, c4, c4)) * math.sqrt(2 / (9 * c4)), dtype=torch.float32),
                torch.as_tensor(rng.standard_normal(c4) * 0.1, dtype=torch.float32),
                torch.as_tensor(rng.standard_normal((c4, c)) * math.sqrt(2 / c4), dtype=torch.float32),
                torch.as_tensor(rng.standard_normal(c) * 0.1, dtype=torch.float32),
            ]
            wts = [t.to(dev, torch.bfloat16 if i % 2 == 0 else torch.float32).contiguous() for i, t in enumerate(wts)]
            x32, w32 = x.float(), [t.float() for t in wts]
            got = bottleneck_block(x, *wts).float()
            expect = bottleneck_block_plain(x32, *w32)
            cos = F.cosine_similarity(got.flatten(), expect.flatten(), dim=0).item()
            rel = ((got - expect).abs().max() / expect.abs().max()).item()
            worst = max(worst, (got - expect).abs().max().item())
            log(f"bottleneck C={c} C4={c4} N={n}: cos={cos:.7f} max_abs/max_ref={rel:.3e}")
            check(cos >= 0.9999 and rel <= 2e-2, f"bottleneck C={c} N={n}: cos >= 0.9999, rel <= 2e-2")
            # library yardstick: the same block as three bf16 cuDNN convs (NCHW, channels-last)
            xl = x.permute(0, 3, 1, 2)
            k1 = wts[0].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
            k2 = wts[2].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            k3 = wts[4].t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
            lib = [k1, wts[1].bfloat16(), k2, wts[3].bfloat16(), k3, wts[5].bfloat16()]
            lib_out = library_block(xl, *lib).permute(0, 2, 3, 1).float()
            lib_cos = F.cosine_similarity(lib_out.flatten(), expect.flatten(), dim=0).item()
            ms = time_ms(lambda: bottleneck_block(x, *wts))
            plain_ms = time_ms(lambda: bottleneck_block_plain(x32, *w32))
            library_ms = time_ms(lambda: library_block(xl, *lib))
            ops = 2.0 * n * h * w * (c * c4 + 9 * c4 * c4 + c4 * c)
            nbytes = 2 * n * h * w * c * 2 + 2 * (2 * c * c4 + 9 * c4 * c4) + 4 * (2 * c4 + c)
            b_ms, b_by = bound(ops, nbytes)
            log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
                f"(cos vs plain {lib_cos:.6f}), bound {b_ms:.4f} ms ({b_by})")
            per_geom[(c, n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, by=b_by)
    # the strategies' other grids (2-scale 69x123, 3-scale 54x97), a partial
    # encode batch (N = 3) and the tests' small grid: checked, not timed
    for n, h, w, c, c4 in ((1, 69, 123, 1024, 256), (1, 54, 97, 512, 128), (3, 60, 107, 1024, 256),
                           (3, 69, 123, 512, 128), (1, 13, 27, 512, 128)):
        x = torch.as_tensor(rng.standard_normal((n, h, w, c)), dtype=torch.float32).to(dev, torch.bfloat16)
        shapes = [(c, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, c), (c,)]
        scales = [math.sqrt(2 / c), 0.1, math.sqrt(2 / (9 * c4)), 0.1, math.sqrt(2 / c4), 0.1]
        wts = [torch.as_tensor(rng.standard_normal(sh) * sc, dtype=torch.float32).to(
            dev, torch.bfloat16 if i % 2 == 0 else torch.float32) for i, (sh, sc) in enumerate(zip(shapes, scales))]
        got = bottleneck_block(x, *wts).float()
        expect = bottleneck_block_plain(x.float(), *[t.float() for t in wts])
        cos = F.cosine_similarity(got.flatten(), expect.flatten(), dim=0).item()
        rel = ((got - expect).abs().max() / expect.abs().max()).item()
        log(f"bottleneck N={n} {h}x{w} C={c} C4={c4}: cos={cos:.7f} max_abs/max_ref={rel:.3e}")
        check(cos >= 0.9999 and rel <= 2e-2, f"bottleneck N={n} {h}x{w} C={c}: cos >= 0.9999, rel <= 2e-2")
    # the main path's encode batch (N = 8): 3 blocks at C=512 and 8 at C=1024
    batch = {key: 3 * per_geom[(512, 8)][key] + 8 * per_geom[(1024, 8)][key]
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"bottleneck per N=8 encode batch (11 launches): kernel {batch['ms']:.4f} ms, "
        f"plain {batch['plain_ms']:.4f} ms, library {batch['library_ms']:.4f} ms, bound {batch['bound_ms']:.4f} ms; "
        f"kernel / library {batch['ms'] / batch['library_ms']:.3f}")
    return dict(max_abs_err=worst, bound_by=per_geom[(1024, 8)]["by"], **batch)


# ---- phases 6 to 9: encoder, main path, kernel 3's path, strategies ------


def random_vosnet(torch, seed: int, arch: str = "resnet50"):
    """VOSNet with reference-style random weights and perturbed BN running
    statistics, drawn from one generator: the JAX package's recipe for its
    encoder gate. Its features all but share one direction (a per-pixel
    cosine of 0.999 to their mean), so label propagation with it returns
    background everywhere."""
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet(arch).eval()
    g = torch.Generator().manual_seed(seed)
    init_weights(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.normal_(0.0, 1.0, generator=g).abs_().mul_(0.5).add_(0.5)
    return net


def calibrated_vosnet(torch, dev, seed: int, frames_u8: np.ndarray, arch: str = "resnet50"):
    """VOSNet whose features tell pixels apart, so that propagated
    masks carry the objects: random convolutions and perturbed BN affine
    parameters from one generator, each residual branch's last BN scale cut
    to a tenth, and the BN running statistics estimated on ``frames_u8``
    (one float32 pass in training mode), as a trained network's would be.
    Without the cut the random network is chaotic (bf16 rounding alone
    moves its features to a median cosine of 0.78)."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet(arch)
    g = torch.Generator().manual_seed(seed)
    init_weights(net, g)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for m in bns:
            m.weight.normal_(1.0, 0.1, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.reset_running_stats()
            m.momentum = None  # a cumulative average: one pass gives the batch statistics
        for m in net.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(0.1)
        x = torch.as_tensor(frames_u8, device=dev).float() / 255.0
        x = (x - torch.as_tensor(IMAGENET_MEAN, device=dev)) / torch.as_tensor(IMAGENET_STD, device=dev)
        net.to(dev).train()(x.permute(0, 3, 1, 2))
    for m in bns:
        m.momentum = 0.1
    return net.eval()


def make_davis_tree(root: Path, videos: dict, size, seed: int) -> None:
    """DAVIS layout: JPEGs and palette PNGs (two moving objects on texture)."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.ops.onehot import davis_palette

    rng = np.random.default_rng(seed)
    h, w = size
    palette = davis_palette().reshape(-1).tolist()
    for v_i, (video, n) in enumerate(videos.items()):
        img_dir = root / "JPEGImages" / "480p" / video
        ann_dir = root / "Annotations" / "480p" / video
        img_dir.mkdir(parents=True)
        ann_dir.mkdir(parents=True)
        bg = rng.integers(0, 90, size=(h, w, 3), dtype=np.uint8)
        for t in range(n):
            img, label = bg.copy(), np.zeros((h, w), np.uint8)
            y, x = h // 4 + v_i * 8, w // 6 + t * 4
            img[y : y + h // 3, x : x + w // 5] = [210, 50 + 20 * v_i, 40]
            label[y : y + h // 3, x : x + w // 5] = 1
            y2, x2 = 2 * h // 3, max(0, w // 2 - t * 3)
            img[y2 : y2 + h // 6, x2 : x2 + w // 6] = [40, 90, 220]
            label[y2 : y2 + h // 6, x2 : x2 + w // 6] = 2
            Image.fromarray(img).save(img_dir / f"{t:05d}.jpg", quality=92)
            ann = Image.fromarray(label, mode="P")
            ann.putpalette(palette)
            ann.save(ann_dir / f"{t:05d}.png")


def encoder_phase(torch, dev, net, frame_u8):
    """The BN-folded bf16 encoder against the float32 module on one 480p
    frame, with its fused-bottleneck launches (11 for resnet50, 8 for
    facebook, whose 2048-wide layer4 runs on cuDNN)."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.tensor(frame_u8[None], device=dev).float() / 255.0
    x = (x - torch.as_tensor(IMAGENET_MEAN, device=dev)) / torch.as_tensor(IMAGENET_STD, device=dev)
    net = net.to(dev)
    with torch.no_grad():
        table = fold_vosnet(net, torch.bfloat16)
        bottleneck_block.launches = 0
        fast = fast_encode(table, x, torch.bfloat16, arch=net.model).float()
        launches = bottleneck_block.launches
        ref = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    cos = torch.nn.functional.cosine_similarity(fast.reshape(-1, 256), ref.reshape(-1, 256), dim=-1)
    log(f"encoder {net.model} 480x854: features {tuple(fast.shape)}, min per-pixel cosine {cos.min().item():.6f}, "
        f"bottleneck launches {launches}")
    check(bool(torch.isfinite(fast).all()) and cos.min().item() >= ENCODER_MIN_COS,
          f"{net.model} encoder min cosine >= {ENCODER_MIN_COS}")
    check(launches == BOTTLENECK_LAUNCHES[net.model], f"{BOTTLENECK_LAUNCHES[net.model]} fused bottleneck launches "
          f"per {net.model} encode")
    return cos.min().item()


def main_path_phase(torch, dev, work: Path, net, videos: dict):
    """``inference`` (default device) with ``net``'s model, then
    ``evaluation``, on the main path's tree."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint

    arch = net.model
    ckpt, save = work / f"{arch}.pth.tar", work / f"pred_{arch}"
    save_torch_checkpoint(net, ckpt)
    # default --device: cuda
    wall, launches = cli_run(torch, ["inference", "-d", str(work / "davis"), "-r", str(ckpt), "-s", str(save),
                                     "--model", arch])
    n_frames = sum(videos.values())
    chunk = chunk_len()
    encode_batches = sum(1 + math.ceil((n - 1) / chunk) for n in videos.values())
    log(f"main path {arch}: {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} fps end to end; "
        f"launches {launches}")
    for video, n in videos.items():
        pngs = sorted((save / video).glob("*.png"))
        check([p.name for p in pngs] == [f"{t:05d}.png" for t in range(n)], f"{video}: one PNG per frame ({n})")
        classes = sorted(set().union(*(np.unique(np.asarray(Image.open(p))).tolist() for p in pngs[1:])))
        check(classes == [0, 1, 2], f"{video}: the predicted masks carry both objects ({classes})")
    check(launches["affinity_bank"] == n_frames - len(videos), "one affinity launch per propagated frame")
    check(launches["affinity_propagate"] == 0, "no affinity_propagate_fused launch on the main path")
    per_call = BOTTLENECK_LAUNCHES[arch]
    check(launches["bottleneck"] == per_call * encode_batches,
          f"{per_call} bottleneck launches x {encode_batches} encode batches")
    j, f, jf = evaluation_command_impl(work / "davis" / "Annotations" / "480p", save)
    log(f"main path {arch} J={j:.6f} F={f:.6f} J&F={jf:.6f}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in (j, f, jf)), "J&F finite in [0, 1]")
    return launches, n_frames / wall, jf


def engine_timing(torch, dev, net, work: Path, video: str, n: int):
    """Engine time per frame on the card with the frames already decoded
    (CUDA events around start_video + every chunk)."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    frames = np.stack([np.asarray(Image.open(work / "davis" / "JPEGImages" / "480p" / video / f"{t:05d}.jpg"))
                       for t in range(n)])
    label = np.asarray(Image.open(work / "davis" / "Annotations" / "480p" / video / "00000.png")).astype(np.int32)
    engine = PropagationEngine(net, (H480, W480), EngineConfig(), dev)
    chunk = chunk_len()

    def run():
        state = engine.start_video(frames[0], label)
        for s in range(1, n, chunk):
            _, state = engine.step_chunk_small(frames[s : s + chunk], state, s)

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    log(f"{net.model} engine on the card, decoded frames: {ms:.4f} ms/frame ({1000.0 / ms:.3f} fps) over {n} frames")
    return ms


def shrunk_clip(work: Path, n: int, h: int, w: int):
    """The long video's first n frames (bilinear) and first annotation
    (nearest) shrunk to h x w. Shrinking keeps the frames smooth; a clip
    drawn at this size has per-pixel noise on which the bf16 encoder alone
    moves 2.5 % of the masks (see PERF.md)."""
    from PIL import Image

    src = work / "davis"
    frames = np.stack([np.asarray(Image.open(src / "JPEGImages" / "480p" / "long" / f"{t:05d}.jpg")
                                  .resize((w, h), Image.BILINEAR)) for t in range(n)])
    label = np.asarray(Image.open(src / "Annotations" / "480p" / "long" / "00000.png")
                       .resize((w, h), Image.NEAREST)).astype(np.int32)
    return frames, label


def small_clip_parity(torch, dev, net, work: Path):
    """Card (bf16, both kernels) vs CPU (float32, golden) engine masks on the
    long video's first 12 frames shrunk to 120x214, past a ring wrap
    (frame_range 6): they differ only where bf16 moves a near-tie."""
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    h, w, n = SMALL_CLIP
    frames, label = shrunk_clip(work, n, h, w)
    cfg = EngineConfig(frame_range=6)
    out = {}
    for device in ("cpu", dev):
        engine = PropagationEngine(net, (h, w), cfg, device)
        state = engine.start_video(frames[0], label)
        masks, _ = engine.step_chunk_small(frames[1:], state, 1)
        out[str(device)] = masks.cpu().numpy()
    net.to(dev)
    agree = float((out["cpu"] == out[str(dev)]).mean())
    classes = np.unique(out["cpu"]).tolist()
    log(f"small clip {h}x{w}, {n} frames, {net.model}: CPU mask classes {classes}, card vs CPU mask agreement "
        f"{agree:.6f}")
    check(classes == [0, 1, 2], f"{net.model}: the CPU engine's masks carry both objects")
    check(agree >= 0.98, f"{net.model}: card masks agree with the CPU engine on >= 98% of pixels")
    return agree


def load_video(work: Path, tree: str, video: str, n: int):
    from PIL import Image

    root = work / tree
    frames = np.stack([np.asarray(Image.open(root / "JPEGImages" / "480p" / video / f"{t:05d}.jpg"))
                       for t in range(n)])
    label = np.asarray(Image.open(root / "Annotations" / "480p" / video / "00000.png")).astype(np.int32)
    return frames, label


def propagate_path(torch, dev, net, work: Path, video: str, n: int):
    """affinity_propagate_fused's own path: the video propagated frame by
    frame through the library op, as a caller of ``core.affinity_propagate``
    would (features kept per frame, the sampled set gathered, the argmax
    one-hot appended), from the engine's encoder features; its masks held
    against the engine's (the bank kernel on the same bf16 inputs)."""
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block
    from semi_supervised_vos_tpu_torch.ops.onehot import index_to_onehot
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize

    frames, label = load_video(work, "strategies", video, n)
    cfg = EngineConfig()
    engine = PropagationEngine(net, (H480, W480), cfg, dev)
    chunk = chunk_len()
    state = engine.start_video(frames[0], label)
    engine_masks = [engine.step_chunk_small(frames[s : s + chunk], state, s)[0] for s in range(1, n, chunk)]
    engine_masks = torch.cat(engine_masks).reshape(n - 1, -1)
    # the same encode batches as the engine's, so the features are the same
    feats = torch.cat([engine.encode(frames[:1])] + [engine.encode(frames[s : s + chunk]) for s in range(1, n, chunk)])
    label_small = nearest_resize(torch.as_tensor(label, device=dev)[:, :, None], (engine.hd, engine.wd))
    labels = [index_to_onehot(label_small.reshape(-1), cfg.num_classes)]
    masks = []
    aff.affinity_from_bank_batched.launches = aff.affinity_propagate_fused.launches = 0
    bottleneck_block.launches = 0
    t0 = time.perf_counter()
    for t in range(1, n):
        idx, valid, dense = sample_frames(t, cfg.frame_range, cfg.ref_num)
        sel = torch.as_tensor(idx, device=dev)
        pred = aff.affinity_propagate_fused(
            feats[sel], feats[t], torch.stack(labels)[sel], feature_hw=(engine.hd, engine.wd),
            temperature=cfg.temperature, valid=valid, dense=dense,
        )
        masks.append(pred.argmax(0))
        labels.append(index_to_onehot(masks[-1], cfg.num_classes))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"affinity_bank": aff.affinity_from_bank_batched.launches,
                "affinity_propagate": aff.affinity_propagate_fused.launches, "bottleneck": bottleneck_block.launches}
    agree = (torch.stack(masks) == engine_masks).double().mean().item()
    classes = torch.unique(torch.stack(masks)).tolist()
    log(f"affinity_propagate_fused path: {n - 1} frames in {wall:.3f} s, launches {launches}, "
        f"mask classes {classes}, agreement with the engine's masks {agree:.6f}")
    check(launches == {"affinity_bank": 0, "affinity_propagate": n - 1, "bottleneck": 0},
          "one affinity_propagate_fused launch per propagated frame, no other kernel")
    check(classes == [0, 1, 2], "its masks carry both objects")
    check(agree >= 0.999, "its masks agree with the engine's on >= 99.9% of pixels")
    return launches["affinity_propagate"]


# (name, extra CLI flags, streams); 3-scale's three passes count as streams
STRATEGY_RUNS = [
    ("single", [], 1),
    ("hor-flip", ["--inference-strategy", "hor-flip"], 2),
    ("vert-flip", ["--inference-strategy", "vert-flip"], 2),
    ("2-scale", ["--inference-strategy", "2-scale"], 2),
    ("hor-2-scale", ["--inference-strategy", "hor-2-scale"], 2),
    ("multimodel", ["--inference-strategy", "multimodel"], 2),
    ("3-scale", ["--inference-strategy", "3-scale"], 3),
    ("single --probability", ["--probability"], 1),
    ("hor-flip --probability --fusion mean", ["--inference-strategy", "hor-flip", "--probability"], 2),
    ("hor-flip --probability --fusion maximum",
     ["--inference-strategy", "hor-flip", "--probability", "--fusion", "maximum"], 2),
    ("hor-flip --probability --fusion minimum",
     ["--inference-strategy", "hor-flip", "--probability", "--fusion", "minimum"], 2),
]


def cli_run(torch, args):
    """One ``inference`` through the CLI with every launch count set to 0
    just before it: (seconds, {kernel: launches})."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    aff.affinity_from_bank_batched.launches = aff.affinity_propagate_fused.launches = 0
    bottleneck_block.launches = 0
    t0 = time.perf_counter()
    cli(args, standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, {"affinity_bank": aff.affinity_from_bank_batched.launches,
                  "affinity_propagate": aff.affinity_propagate_fused.launches, "bottleneck": bottleneck_block.launches}


def check_outputs(save: Path, gt: Path, videos: dict, name: str) -> float:
    """One PNG per frame, both objects in the predicted masks, J&F finite."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl

    for video, n in videos.items():
        pngs = sorted((save / video).glob("*.png"))
        check([p.name for p in pngs] == [f"{t:05d}.png" for t in range(n)], f"{name} {video}: one PNG per frame")
        classes = sorted(set().union(*(np.unique(np.asarray(Image.open(p))).tolist() for p in pngs[1:])))
        check(classes == [0, 1, 2], f"{name} {video}: the predicted masks carry both objects ({classes})")
    _, _, jf = evaluation_command_impl(gt, save, processes=1)
    check(math.isfinite(jf) and 0.0 <= jf <= 1.0, f"{name}: J&F {jf:.6f} finite in [0, 1]")
    return jf


def strategies_phase(torch, dev, work: Path, net, net2, n: int):
    """Every strategy through the CLI on the card at 480p, on one n-frame
    video; the launch counts are streams x propagated frames (the final
    partial chunk of a multi-stream run is padded to a whole chunk) and 11 x
    encode batches x streams."""
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint

    tree = work / "strategies"
    ckpt, ckpt2 = work / "resnet50.pth.tar", work / "resnet50_seed1.pth.tar"
    save_torch_checkpoint(net2, ckpt2)
    chunk = chunk_len()
    chunks = math.ceil((n - 1) / chunk)
    results = {}
    for i, (name, flags, streams) in enumerate(STRATEGY_RUNS):
        save = work / f"strategy{i}"
        args = ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save), *flags]
        if "multimodel" in flags:
            args += ["--additional-model", str(ckpt2)]
        wall, launches = cli_run(torch, args)
        propagated = chunks * chunk if streams == 2 else n - 1
        expect = {"affinity_bank": streams * propagated, "affinity_propagate": 0,
                  "bottleneck": 11 * streams * (1 + chunks)}
        jf = check_outputs(save, tree / "Annotations" / "480p", {"clip": n}, name)
        log(f"strategy {name}: {n} frames in {wall:.3f} s = {n / wall:.3f} fps end to end, J&F {jf:.6f}, "
            f"launches {launches}")
        check(launches == expect, f"{name}: launches {expect}")
        results[name] = dict(fps=n / wall, seconds=wall, jf=jf, launches=launches)
    return results


def twenty_refs_run(torch, work: Path, videos: dict):
    """``-n 20`` on the main path's tree: 20 reference slots a frame."""
    save = work / "pred_n20"
    args = ["inference", "-d", str(work / "davis"), "-r", str(work / "resnet50.pth.tar"), "-s", str(save), "-n", "20"]
    wall, launches = cli_run(torch, args)
    propagated = sum(videos.values()) - len(videos)
    jf = check_outputs(save, work / "davis" / "Annotations" / "480p", videos, "-n 20")
    log(f"-n 20: {sum(videos.values())} frames in {wall:.3f} s, J&F {jf:.6f}, launches {launches}")
    check(launches["affinity_bank"] == propagated and launches["affinity_propagate"] == 0,
          "-n 20: one affinity launch per propagated frame")


def strategies_cpu_parity(torch, work: Path):
    """Card vs CPU (``--device cpu``: float32, golden affinity) PNGs for
    probability mode and for hor-flip, on the small clip of
    :func:`small_clip_parity` written as a DAVIS tree, past a ring wrap
    (``--frame_range 6``): they differ only where bf16 moves a near-tie."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_palette

    h, w, n = SMALL_CLIP
    tree = work / "small"
    frames, label = shrunk_clip(work, n, h, w)
    (tree / "JPEGImages" / "480p" / "small").mkdir(parents=True)
    (tree / "Annotations" / "480p" / "small").mkdir(parents=True)
    for t, frame in enumerate(frames):
        Image.fromarray(frame).save(tree / "JPEGImages" / "480p" / "small" / f"{t:05d}.jpg", quality=92)
    ann = Image.fromarray(label.astype(np.uint8), mode="P")
    ann.putpalette(davis_palette().reshape(-1).tolist())
    ann.save(tree / "Annotations" / "480p" / "small" / "00000.png")
    base = ["inference", "-d", str(tree), "-r", str(work / "resnet50.pth.tar"), "--frame_range", "6"]
    for name, flags in (("single --probability", ["--probability"]), ("hor-flip", ["--inference-strategy", "hor-flip"])):
        out = {}
        for device in ("cpu", "cuda"):
            save = work / f"small_{device}_{flags[-1]}"
            cli(base + ["-s", str(save), "--device", device, *flags], standalone_mode=False)
            out[device] = np.stack([np.asarray(Image.open(save / "small" / f"{t:05d}.png")) for t in range(1, n)])
        agree = float((out["cpu"] == out["cuda"]).mean())
        classes = np.unique(out["cpu"]).tolist()
        log(f"small clip {h}x{w}, {n} frames, {name}: CPU mask classes {classes}, card vs CPU agreement {agree:.6f}")
        check(classes == [0, 1, 2], f"{name}: the CPU masks carry both objects")
        check(agree >= 0.98, f"{name}: card masks agree with the CPU's on >= 98% of pixels")


# ---- phase 10: the lockstep engine (--video-batch) -------------------------


def png_agreement(save_a: Path, save_b: Path, videos: dict, name: str) -> float:
    """Both runs wrote one PNG per frame; the share of predicted pixels
    (frames 1 on) on which they agree."""
    from PIL import Image

    same = total = 0
    for video, n in videos.items():
        for save in (save_a, save_b):
            names = [p.name for p in sorted((save / video).glob("*.png"))]
            check(names == [f"{t:05d}.png" for t in range(n)], f"{name} {save.name} {video}: one PNG per frame ({n})")
        for t in range(1, n):
            a = np.asarray(Image.open(save_a / video / f"{t:05d}.png"))
            b = np.asarray(Image.open(save_b / video / f"{t:05d}.png"))
            same += int((a == b).sum())
            total += a.size
    return same / total


def lockstep_launches(engines, t_max: int) -> dict:
    """Launches of one lockstep group whose engines are ``(frame_hw,
    lanes)``: one bank-kernel launch per engine and step (the last chunk
    padded to a whole chunk), 11 bottleneck launches per encode call (the
    start, then each chunk's frames in calls of at most the lane cap)."""
    from semi_supervised_vos_tpu_torch.infer.batched import _hbm_lanes_cap
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    chunk = chunk_len()
    chunks = math.ceil((t_max - 1) / chunk)
    encodes = sum(1 + chunks * math.ceil(chunk / max(1, _hbm_lanes_cap(hw) // b)) for hw, b in engines)
    return {"affinity_bank": len(engines) * chunks * chunk, "affinity_propagate": 0, "bottleneck": 11 * encodes}


# (name, CLI flags, engines as (input scale, lanes per video)) of the 10b
# runs; 2-scale's second engine and 3-scale's passes run at ceil(scale x
# the frame size)
LOCKSTEP_RUNS = [
    ("hor-flip", ["--inference-strategy", "hor-flip"], [(1.0, 2)]),
    ("hor-flip --probability --fusion mean", ["--inference-strategy", "hor-flip", "--probability"], [(1.0, 2)]),
    ("vert-flip", ["--inference-strategy", "vert-flip"], [(1.0, 2)]),
    ("2-scale", ["--inference-strategy", "2-scale"], [(1.0, 1), (1.15, 1)]),
    ("hor-2-scale", ["--inference-strategy", "hor-2-scale"], [(1.0, 1), (1.15, 1)]),
    ("multimodel", ["--inference-strategy", "multimodel"], [(1.0, 1)] * 2),
    ("multimodel --probability", ["--inference-strategy", "multimodel", "--probability"], [(1.0, 1)] * 2),
    ("3-scale", ["--inference-strategy", "3-scale"], [(0.9, 1), (1.0, 1), (1.15, 1)]),
]


def lockstep_cli(torch, work: Path, videos: dict):
    """10a: ``--video-batch 8`` then ``evaluation`` on 8 videos of unequal
    length, against ``--video-batch 1`` on the same tree; timed in turns
    (1, 8, 8, 1) so that neither side alone meets shapes the process has not
    run yet, and the second run of each compared."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl

    tree, ckpt = work / "lockstep", work / "resnet50.pth.tar"
    n_frames = sum(videos.values())
    walls = {1: [], 8: []}
    for i, vb in enumerate((1, 8, 8, 1)):
        args = ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(work / f"lockstep_{i}"), "--video-batch", str(vb)]
        wall, launches = cli_run(torch, args)
        walls[vb].append(wall)
        if vb == 8 and len(walls[8]) == 1:
            launches8, save8 = launches, work / f"lockstep_{i}"
        if vb == 1 and len(walls[1]) == 1:
            launches1, save1 = launches, work / f"lockstep_{i}"
    expect = lockstep_launches([((H480, W480), 8)], max(videos.values()))
    fps8, fps1 = n_frames / walls[8][1], n_frames / walls[1][1]
    log(f"lockstep CLI, {n_frames} frames in turns 1, 8, 8, 1: --video-batch 8 "
        + " and ".join(f"{w:.3f} s" for w in walls[8]) + ", --video-batch 1 "
        + " and ".join(f"{w:.3f} s" for w in walls[1])
        + f"; second runs: --video-batch 8 {fps8:.3f} fps, --video-batch 1 {fps1:.3f} fps end to end ({fps8 / fps1:.3f}x); "
        f"launches {launches8} (--video-batch 1: {launches1})")
    check(launches8 == expect, f"--video-batch 8: one bank-kernel launch per lockstep step, {expect}")
    for video in videos:
        classes = sorted(set().union(*(np.unique(np.asarray(Image.open(p))).tolist()
                                       for p in sorted((save8 / video).glob("*.png"))[1:])))
        check(classes == [0, 1, 2], f"--video-batch 8 {video}: the predicted masks carry both objects ({classes})")
    agree = png_agreement(save8, save1, videos, "--video-batch 8 vs 1")
    j, f, jf = evaluation_command_impl(tree / "Annotations" / "480p", save8)
    log(f"--video-batch 8 vs 1: mask agreement {agree:.7f}; --video-batch 8 J={j:.6f} F={f:.6f} J&F={jf:.6f}")
    check(agree >= 0.999, "--video-batch 8 masks agree with --video-batch 1 on >= 99.9% of pixels")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in (j, f, jf)), "--video-batch 8 J&F finite in [0, 1]")
    return dict(fps_vb8=fps8, fps_vb1=fps1, seconds_vb8=walls[8], seconds_vb1=walls[1], frames=n_frames,
                steps=expect["affinity_bank"], agreement=agree, jf=jf, launches_vb8=launches8, launches_vb1=launches1)


def lockstep_strategies(torch, work: Path, videos: dict):
    """10b: every lockstep runner through the CLI at ``--video-batch 2`` on
    a 2-video tree, against the same strategy at ``--video-batch 1``."""
    tree = work / "lockstep2"
    results = {}
    for i, (name, flags, engines) in enumerate(LOCKSTEP_RUNS):
        saves = {vb: work / f"lockstep2_{i}_vb{vb}" for vb in (2, 1)}
        walls, launches = {}, {}
        for vb, save in saves.items():
            args = ["inference", "-d", str(tree), "-r", str(work / "resnet50.pth.tar"), "-s", str(save),
                    "--video-batch", str(vb), *flags]
            if "multimodel" in flags:
                args += ["--additional-model", str(work / "resnet50_seed1.pth.tar")]
            walls[vb], launches[vb] = cli_run(torch, args)
        hws = [(int(np.ceil(H480 * sc)), int(np.ceil(W480 * sc))) for sc, _ in engines]
        expect = lockstep_launches([(hw, 2 * lanes) for hw, (_, lanes) in zip(hws, engines)], max(videos.values()))
        agree = png_agreement(saves[2], saves[1], videos, name)
        log(f"lockstep {name} --video-batch 2: {walls[2]:.3f} s (--video-batch 1: {walls[1]:.3f} s), "
            f"launches {launches[2]}, mask agreement with --video-batch 1 {agree:.7f}")
        check(launches[2] == expect, f"lockstep {name}: launches {expect}")
        check(agree >= 0.999, f"lockstep {name}: masks agree with --video-batch 1 on >= 99.9% of pixels")
        results[name] = dict(launches=launches[2], agreement=agree, seconds_vb2=walls[2], seconds_vb1=walls[1])
    return results


def lockstep_engine_timing(torch, dev, net, work: Path, videos: dict):
    """10c: device ms per lane-frame of the lockstep engine on decoded frames
    (CUDA events around start_videos + two 8-step chunks) at B = 1 to 16."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    names = list(videos)
    t_max = max(videos.values())
    clips = {v: load_video(work, "lockstep", v, videos[v]) for v in names}
    chunk = chunk_len()
    out = {}
    for b in (1, 2, 4, 8, 16):
        lanes = [names[i % len(names)] for i in range(b)]
        frames = np.stack([np.stack([clips[v][0][min(t, videos[v] - 1)] for v in lanes]) for t in range(t_max)])
        labels = np.stack([clips[v][1] for v in lanes])
        engine = BatchedPropagationEngine(net, (H480, W480), b, EngineConfig(), dev)

        def run():
            state = engine.start_videos(frames[0], labels)
            for s in range(1, t_max, chunk):
                _, state = engine.step_chunk_small(frames[s : s + chunk], state, s)

        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        end.synchronize()
        out[b] = start.elapsed_time(end) / (b * t_max)
        log(f"lockstep engine B={b}: {out[b]:.4f} ms per lane-frame ({1000.0 / out[b]:.3f} lane-frames/s)")
        del engine
    return out


def lockstep_kernels(torch, dev, rng):
    """10c: both kernels at the lockstep shapes: the bank kernel at B = 8 and
    16 against its plain version lane by lane (the plain version holds a
    lane's (K, P, P) scores at once), timed at B = 8 against 8 x the B = 1
    bound, and in probability mode beside ``scaled_dot_product_attention``
    at batch 8; the bottleneck at N = 64 (a B = 8 chunk's encode call)
    against its plain version, timed beside cuDNN."""
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block, bottleneck_block_plain

    c, d, d_pad, cap, k, hd, wd = 256, 22, 24, 45, 9, 60, 107
    p = hd * wd
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    res = {}
    worst = 0.0
    # banks of up to 16 lanes (1.2 G values): drawn on the card from a seed
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    for b in (8, 16):
        feats = (torch.randn((cap, b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16)
        labels = torch.nn.functional.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev), d_pad)
        labels = labels.to(torch.bfloat16)
        tgt = (torch.randn((b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16).float()
        for spatial in (True, False):
            kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, spatial=spatial)
            got = aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)[:, :d]
            max_abs, agree = 0.0, 0.0
            for lane in range(b):
                expect = aff.affinity_from_bank_plain(feats[:, lane : lane + 1].float(), labels[:, lane : lane + 1].float(),
                                                      tgt[lane : lane + 1], slots, **kw)[0, :d]
                max_abs = max(max_abs, (got[lane] - expect).abs().max().item())
                agree += (got[lane].argmax(0) == expect.argmax(0)).double().mean().item() / b
                del expect
            worst = max(worst, max_abs)
            mode = "prior on" if spatial else "probability mode"
            log(f"affinity B={b} 480p {mode}: max_abs={max_abs:.3e} argmax_agreement={agree:.7f}")
            check(max_abs <= AFFINITY_GATE and agree >= 0.999, f"affinity B={b} {mode} <= {AFFINITY_GATE} / 0.999")
        if b != 8:
            continue
        _, inv_sigma2, _ = aff.slot_table(slots, valid, dense, 8.0, 21.0, True)
        nbytes = k * p * (c + d_pad) * 2 + p * c * 4 + d_pad * p * 4
        b1_ms, by = affinity_bound(torch, dev, k, p, wd, c, d, inv_sigma2, nbytes)
        b1_prob, by_prob = affinity_bound(torch, dev, k, p, wd, c, d, np.zeros(k), nbytes)
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
        ms = time_ms(lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw))
        prob_ms = time_ms(lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, spatial=False, **kw))
        sel = torch.as_tensor(slots[valid], device=dev)
        q = tgt.to(torch.bfloat16)[:, None]
        keys = feats[sel].permute(1, 0, 2, 3).reshape(b, 1, -1, c).contiguous()
        values = labels[sel].permute(1, 0, 2, 3).reshape(b, 1, -1, d_pad).contiguous()
        run_library = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)  # noqa: E731
        sdpa = run_library()[:, 0, :, :d].float().transpose(1, 2)
        expect = aff.affinity_from_bank_batched(feats, labels, tgt, slots, spatial=False, **kw)[:, :d]
        sdpa_err = (sdpa - expect).abs().max().item()
        check(sdpa_err <= SDPA_GATE, f"scaled_dot_product_attention at batch 8 agrees with the kernel <= {SDPA_GATE}")
        library_ms = time_ms(run_library)
        res.update(b8_ms=ms, b8_bound_ms=8 * b1_ms, b8_bound_by=by, b8_prob_ms=prob_ms,
                   b8_prob_bound_ms=8 * b1_prob, b8_prob_bound_by=by_prob, b8_prob_library_ms=library_ms)
        log(f"affinity B=8 480p: kernel {ms:.4f} ms ({ms / 8:.4f} per lane), bound {8 * b1_ms:.4f} ms ({by}); "
            f"probability mode {prob_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms "
            f"(max_abs vs kernel {sdpa_err:.3e}), bound {8 * b1_prob:.4f} ms; kernel / library "
            f"{prob_ms / library_ms:.3f}")
        del feats, labels, tgt, keys, values
    res["max_abs_err"] = worst

    def library_block(x, k1, b1, k2, b2, k3, b3):
        y = torch.relu(F.conv2d(x, k1, b1))
        y = torch.relu(F.conv2d(y, k2, b2, padding=1))
        return torch.relu(F.conv2d(y, k3, b3) + x)

    n, h, w = 64, 60, 107
    batch = {"ms": 0.0, "library_ms": 0.0}
    for cc, c4, blocks in ((512, 128, 3), (1024, 256, 8)):
        x = torch.as_tensor(rng.standard_normal((n, h, w, cc)), dtype=torch.float32).to(dev, torch.bfloat16)
        shapes = [(cc, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, cc), (cc,)]
        scales = [math.sqrt(2 / cc), 0.1, math.sqrt(2 / (9 * c4)), 0.1, math.sqrt(2 / c4), 0.1]
        wts = [torch.as_tensor(rng.standard_normal(sh) * sc, dtype=torch.float32).to(
            dev, torch.bfloat16 if i % 2 == 0 else torch.float32).contiguous()
            for i, (sh, sc) in enumerate(zip(shapes, scales))]
        got = bottleneck_block(x, *wts).float()
        expect = bottleneck_block_plain(x.float(), *[t.float() for t in wts])
        cos = F.cosine_similarity(got.flatten(), expect.flatten(), dim=0).item()
        rel = ((got - expect).abs().max() / expect.abs().max()).item()
        del got, expect
        log(f"bottleneck N={n} C={cc} C4={c4}: cos={cos:.7f} max_abs/max_ref={rel:.3e}")
        check(cos >= 0.9999 and rel <= 2e-2, f"bottleneck N={n} C={cc}: cos >= 0.9999, rel <= 2e-2")
        xl = x.permute(0, 3, 1, 2)
        lib = [wts[0].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[1].bfloat16(),
               wts[2].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), wts[3].bfloat16(),
               wts[4].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[5].bfloat16()]
        batch["ms"] += blocks * time_ms(lambda: bottleneck_block(x, *wts), reps=10)
        batch["library_ms"] += blocks * time_ms(lambda: library_block(xl, *lib), reps=10)
        del x, xl
    log(f"bottleneck per N=64 encode call (11 launches): kernel {batch['ms']:.4f} ms, library {batch['library_ms']:.4f} "
        f"ms; kernel / library {batch['ms'] / batch['library_ms']:.3f}")
    res.update(bottleneck_n64_ms=batch["ms"], bottleneck_n64_library_ms=batch["library_ms"])
    return res


def lockstep_memory(torch, dev, net, work: Path, slopes: bool = True):
    """10d (and 12d for facebook): peak device memory of one chunk
    (start_videos + one 8-step chunk) at 480p (B = 1, 8) and 1080p (B = 1,
    2), the bytes per lane (with ``slopes``), and one chunk at
    ``_hbm_lanes_cap`` lanes for ``net``'s model at each resolution, which
    must stay under 85 % of the card's memory (the anchors of
    ``infer/batched.py`` aim it at 70 %)."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine, _hbm_lanes_cap
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    frames480, label480 = load_video(work, "lockstep", "v0", chunk_len() + 1)
    total = torch.cuda.get_device_properties(0).total_memory

    def clip(hw):
        if hw == (H480, W480):
            return frames480, label480
        ri = (np.arange(hw[0]) * H480) // hw[0]
        ci = (np.arange(hw[1]) * W480) // hw[1]
        return frames480[:, ri][:, :, ci], label480[ri][:, ci]

    def peak(hw, b):
        frames, label = clip(hw)
        engine = BatchedPropagationEngine(net, hw, b, EngineConfig(), dev)
        lanes = np.broadcast_to(frames[:, None], (frames.shape[0], b) + frames.shape[1:])
        labels = np.broadcast_to(label[None], (b,) + label.shape)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        state = engine.start_videos(np.ascontiguousarray(lanes[0]), np.ascontiguousarray(labels))
        masks, state = engine.step_chunk_small(lanes[1:], state, 1)
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - before
        top = torch.cuda.max_memory_allocated()
        check(bool((masks.max() > 0).item()), f"{hw} B={b}: the chunk's masks carry an object")
        del engine, state, masks
        torch.cuda.empty_cache()
        return used, top

    res = {}
    for name, hw, bs in (("480p", (H480, W480), (1, 8)), ("1080p", (H1080, W1080), (1, 2))):
        lanes = _hbm_lanes_cap(hw, net.model)
        cap_used, cap_top = peak(hw, lanes)
        share = cap_top / total
        # at the cap an encode call takes one step of every lane, so the
        # chunk's bytes per lane there are what sets the anchors
        msg = (f"at the lane cap ({lanes} lanes, one step of each per encode call) {cap_used / 1e9:.4f} GB = "
               f"{cap_used / lanes / 1e9:.4f} GB per lane, peak {cap_top / 1e9:.4f} GB = {share:.4f} of "
               f"{total / 1e9:.3f} GB")
        res[name] = dict(cap_lanes=lanes, cap_bytes=cap_used, cap_bytes_per_lane=cap_used / lanes, cap_peak=cap_top,
                         cap_share=share)
        if slopes:
            used = {b: peak(hw, b)[0] for b in bs}
            per_lane = (used[bs[1]] - used[bs[0]]) / (bs[1] - bs[0])
            msg = (f"one chunk B={bs[0]} {used[bs[0]] / 1e9:.4f} GB, B={bs[1]} {used[bs[1]] / 1e9:.4f} GB, "
                   f"{per_lane / 1e9:.4f} GB per added lane; " + msg)
            res[name].update(bytes_b1=used[bs[0]], bytes_b2_or_b8=used[bs[1]], bytes_per_lane=per_lane)
        log(f"lockstep memory {net.model} {name}: " + msg)
        check(share < 0.85, f"{net.model} {name}: one chunk at {lanes} lanes peaks under 85% of the card's memory")
    res["total_bytes"] = total
    return res


# ---- phase 11: training ----------------------------------------------------

TRAIN_VIDEOS = {f"t{i}": 20 for i in range(4)}  # 80 clips: 5 batches of 16, validation at epoch 0
TRAIN_BS, TRAIN_FRAMES, TRAIN_CROP = 16, 10, 256  # the train CLI's defaults: bs 16 x 10 frames x 256^2
# (label, loss, miner, bf16): each timed from the same initial weights
TRAIN_RUNS = [
    ("cross_entropy", "cross_entropy", None, False),
    ("focal", "focal", None, False),
    ("contrastive", "contrastive", None, False),
    ("triplet default", "triplet", "default", False),
    ("triplet temporal", "triplet", "temporal", False),
    ("triplet skeleton", "triplet", "skeleton", False),
    ("cross_entropy --bf16", "cross_entropy", None, True),
]
TRAIN_STEP_REPS = 10
TRAIN_FALL_STEPS = 20
CARD_VS_CPU_LOSS_RTOL = 1e-4
CARD_VS_CPU_MIN_COS = 0.99999


def kernel_launches():
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    return {"affinity_bank": aff.affinity_from_bank_batched.launches,
            "affinity_propagate": aff.affinity_propagate_fused.launches, "bottleneck": bottleneck_block.launches}


def reset_kernel_launches():
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    aff.affinity_from_bank_batched.launches = aff.affinity_propagate_fused.launches = 0
    bottleneck_block.launches = 0


def conv_flops(torch, net, x) -> float:
    """Multiply-adds x 2 of every convolution in one forward of ``x``."""
    total = []

    def hook(m, inp, out):
        total.append(2.0 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1])

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        net.eval()(x)
    for h in handles:
        h.remove()
    return sum(total)


def training_steps(torch, dev, work: Path, arch: str = "resnet50", runs=TRAIN_RUNS,
                   fall_steps: int = TRAIN_FALL_STEPS):
    """11a (and 12e for facebook): the port's train step at full width (bs
    16 x 10 frames x 256^2 crops of a 480p tree) for each of ``runs``, from
    the same initial weights; device ms per step (CUDA events), peak memory,
    losses finite; then cross-entropy for ``fall_steps`` steps on one fixed
    batch."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net, make_spec
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import iterate_batches, make_geometry_fn, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    tree = work / "train"
    ds = TrainDataset(tree / "JPEGImages" / "480p", tree / "Annotations" / "480p", cropping=TRAIN_CROP,
                      frame_num=TRAIN_FRAMES)
    imgs, anns = next(iterate_batches(ds, TRAIN_BS, num_workers=8))
    imgs_d, anns_d = torch.as_tensor(imgs, device=dev), torch.as_tensor(anns, device=dev)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    net = build_train_net(arch, dev)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    x = (imgs_d.reshape(-1, TRAIN_CROP, TRAIN_CROP, 3).float() / 255.0).permute(0, 3, 1, 2)
    fwd_flops = conv_flops(torch, net, x)
    del x
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"train batch {tuple(imgs.shape)} uint8; {arch} forward {fwd_flops / 1e12:.4f} TFLOP of convolutions a step "
        f"({fwd_flops / imgs.shape[0] / imgs.shape[1] / 1e9:.3f} GFLOP an image)")

    def fresh_step(loss, miner, bf16):
        net.load_state_dict(start)
        net.train()
        spec = make_spec(loss, miner or "default", 0.1, 1.0)
        step = make_train_step(net, spec, make_optimizer(net.parameters()), bf16=bf16)
        geometry_fn = make_geometry_fn(spec, davis_centroids(), dev)
        extra, geo_ms = (), None
        if geometry_fn is not None:
            host = []
            for _ in range(4):  # the first call imports SciPy's morphology
                t0 = time.perf_counter()
                geom = geometry_fn(anns)
                host.append((time.perf_counter() - t0) * 1e3)
            geo_ms = statistics.median(host[1:])
            extra = (tuple(torch.as_tensor(g, device=dev) for g in geom),)
        generator = torch.Generator(device=dev).manual_seed(42)
        return (lambda: step(imgs_d, anns_d, centroids, generator, *extra)), geo_ms

    results = {}
    for label, loss, miner, bf16 in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, geo_ms = fresh_step(loss, miner, bf16)
        losses = []
        t = time_ms(lambda: losses.append(step()), reps=TRAIN_STEP_REPS, warmup=2)
        peak = torch.cuda.max_memory_allocated()
        vals = torch.stack(losses).cpu()
        r = dict(**timing_keys("ms", t), steps_per_s=1e3 / float(t), clips_per_s=TRAIN_BS * 1e3 / float(t),
                 model_tflops_per_s=3 * fwd_flops / (float(t) * 1e-3) / 1e12, peak_bytes=peak,
                 peak_share=peak / total, loss_first=float(vals[0]), loss_last=float(vals[-1]))
        if geo_ms is not None:
            r["host_geometry_ms"] = geo_ms
        log(f"train step {arch} {label}: {t:.3f} ms = {r['steps_per_s']:.3f} steps/s ({r['clips_per_s']:.2f} clips/s, "
            f"{r['model_tflops_per_s']:.1f} TFLOP/s at 3x the forward), peak {peak / 2**30:.3f} GiB = "
            f"{r['peak_share']:.4f} of the card, losses {r['loss_first']:.6f} .. {r['loss_last']:.6f}"
            + (f", host geometry {geo_ms:.3f} ms a batch" if geo_ms is not None else ""))
        check(bool(torch.isfinite(vals).all()), f"{label}: every loss finite")
        results[label] = r
    fall = []
    if fall_steps:
        step, _ = fresh_step("cross_entropy", None, False)
        fall = torch.stack([step() for _ in range(fall_steps)]).cpu().tolist()
        log(f"cross_entropy over {fall_steps} steps on one batch: " + " ".join(f"{v:.5f}" for v in fall))
        check(all(math.isfinite(v) for v in fall) and fall[-1] < 0.9 * fall[0],
              f"cross-entropy falls by more than 10 % over {fall_steps} steps")
    del net, step
    torch.cuda.empty_cache()
    return results, dict(fwd_tflop=fwd_flops / 1e12, fall=fall)


def training_cli(torch, work: Path):
    """11b: ``train`` through the CLI (default device, resnet50, 2 epochs,
    --early-stop), ``validation`` on its checkpoints, then ``inference`` and
    ``evaluation`` with the last one. The kernels' launch counts over
    train and validation are the training path's."""
    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl

    tree, ckpts = work / "train", work / "train_ckpts"
    reset_kernel_launches()
    t0 = time.perf_counter()
    cli(["train", "-t", str(tree), "-v", str(tree), "-m", str(ckpts), "--epochs", "2", "--early-stop"],
        standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    clips = 2 * (sum(n for n in TRAIN_VIDEOS.values()) // TRAIN_BS) * TRAIN_BS
    names = sorted(p.name for p in ckpts.iterdir())
    log(f"train CLI: {clips} clips in 2 epochs (validation of 80 clips at epoch 0) in {wall:.3f} s = "
        f"{clips / wall:.3f} clips/s end to end; checkpoints {names}")
    epochs = [n for n in names if n.startswith("checkpoint-epoch-")]
    check(len(epochs) == 2 and "model.pth.tar" in names, "two epoch checkpoints and the early-stopping best")
    train_losses = [float(n.split("-")[3]) for n in epochs]
    val_in_name = float(epochs[0].split("-")[4][: -len(".pth.tar")])
    check(all(math.isfinite(v) for v in train_losses + [val_in_name]), "losses in the names finite")
    out = work / "validation.json"
    t0 = time.perf_counter()
    cli(["validation", "-d", str(tree), "-c", str(ckpts), "-o", str(out)], standalone_mode=False)
    val_wall = time.perf_counter() - t0
    launches = kernel_launches()
    val = json.loads(out.read_text())
    log(f"validation CLI: {val} in {val_wall:.3f} s; kernel launches over train and validation {launches}")
    check(sorted(val) == names and all(math.isfinite(v) for v in val.values()), "validation: a finite loss a checkpoint")
    check(abs(val[epochs[0]] - val_in_name) <= 1e-3 * abs(val_in_name),
          "validation CLI on epoch 0's checkpoint reproduces the train CLI's epoch-0 validation loss to 1e-3")
    check(launches == {"affinity_bank": 0, "affinity_propagate": 0, "bottleneck": 0},
          "no hand-written kernel runs on the training path")
    pred = work / "train_pred"
    t0 = time.perf_counter()
    cli(["inference", "-d", str(tree), "-r", str(ckpts / epochs[-1]), "-s", str(pred)], standalone_mode=False)
    torch.cuda.synchronize()
    infer_wall = time.perf_counter() - t0
    j, f, jf = evaluation_command_impl(tree / "Annotations" / "480p", pred, processes=1)
    log(f"inference with {epochs[-1]}: {sum(TRAIN_VIDEOS.values())} frames in {infer_wall:.3f} s; "
        f"J={j:.6f} F={f:.6f} J&F={jf:.6f}")
    check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in (j, f, jf)), "J&F after train -> inference finite in [0, 1]")
    return dict(clips_per_s=clips / wall, seconds=wall, clips=clips, train_losses=train_losses,
                val_loss_epoch0=val_in_name, validation=val, validation_seconds=val_wall, jf=jf, j=j, f=f,
                launches=launches)


def training_card_vs_cpu(torch, dev):
    """11c: one cross-entropy step at resnet18, 64^2 crops, bs 2 x 3 frames,
    on the card and on the CPU from the same weights, TF32 off."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net, make_spec
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    rng = np.random.default_rng(11)
    imgs = rng.integers(0, 255, (2, 3, 64, 64, 3)).astype(np.uint8)
    anns = np.zeros((2, 3, 64, 64, 3), np.uint8)
    anns[:, :, 8:40, 12:44] = [128, 0, 0]
    anns[:, :, 36:60, 32:60] = [0, 128, 0]
    out = {}
    for device in (torch.device("cpu"), dev):
        net = build_train_net("resnet18", device).train()
        step = make_train_step(net, make_spec("cross_entropy", "default", 0.1, 1.0), make_optimizer(net.parameters()))
        loss = step(torch.as_tensor(imgs, device=device), torch.as_tensor(anns, device=device),
                    torch.as_tensor(davis_centroids(), dtype=torch.float32, device=device), None)
        out[device.type] = (loss.item(), torch.cat([p.detach().flatten().cpu().double() for p in net.parameters()]))
    (l_cpu, p_cpu), (l_card, p_card) = out["cpu"], out["cuda"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    cos = torch.nn.functional.cosine_similarity(p_card, p_cpu, dim=0).item()
    log(f"card vs CPU, one resnet18 step at 64^2, bs 2 x 3, TF32 off: loss {l_card:.7f} vs {l_cpu:.7f} "
        f"(relative {rel:.2e}), parameters' cosine {cos:.8f}")
    check(rel <= CARD_VS_CPU_LOSS_RTOL, f"card loss within {CARD_VS_CPU_LOSS_RTOL} of the CPU's")
    check(cos >= CARD_VS_CPU_MIN_COS, f"parameters' cosine >= {CARD_VS_CPU_MIN_COS}")
    return dict(loss_card=l_card, loss_cpu=l_cpu, loss_rel=rel, param_cosine=cos)


def training_phase(torch, dev, work: Path):
    """Phase 11 at PyTorch's default precision (cuDNN convolutions in TF32,
    float32 matmuls), then the card-vs-CPU step in full float32."""
    make_davis_tree(work / "train", TRAIN_VIDEOS, (H480, W480), seed=5)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        steps, extra = training_steps(torch, dev, work)
        cli_res = training_cli(torch, work)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    parity = training_card_vs_cpu(torch, dev)
    return dict(precision="cuDNN convolutions TF32 (PyTorch default), matmuls float32", steps=steps, **extra,
                cli=cli_res, card_vs_cpu=parity)


# ---- phase 12: facebook ----------------------------------------------------


def tf32_flags_kept(torch, dev, net, frames_u8, label):
    """With both TF32 flags True, building a single and a lockstep engine
    and running one step of each leaves them True; the flags are restored
    after."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        engine = PropagationEngine(net, frames_u8.shape[1:3], EngineConfig(), dev)
        engine.step_chunk_small(frames_u8[1:2], engine.start_video(frames_u8[0], label), 1)
        lockstep = BatchedPropagationEngine(net, frames_u8.shape[1:3], 2, EngineConfig(), dev)
        pair = np.stack([frames_u8[:2]] * 2, axis=1)
        lockstep.step_chunk_small(pair[1:2], lockstep.start_videos(pair[0], np.stack([label] * 2)), 1)
        torch.cuda.synchronize()
        kept = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    log(f"TF32 flags after a {net.model} single and lockstep engine step: cudnn {kept[0]}, matmul {kept[1]}")
    check(kept == (True, True), "building and stepping the engines leaves both TF32 flags as the caller set them")


def facebook_multimodel(torch, work: Path, n: int):
    """12c: ``multimodel`` through the CLI with resnet50 first and facebook
    (``--additional-model-type facebook``) second, on the strategies' clip."""
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    tree, save = work / "strategies", work / "facebook_multimodel"
    args = ["inference", "-d", str(tree), "-r", str(work / "resnet50.pth.tar"), "-s", str(save),
            "--inference-strategy", "multimodel", "--additional-model", str(work / "facebook.pth.tar"),
            "--additional-model-type", "facebook"]
    wall, launches = cli_run(torch, args)
    chunks = math.ceil((n - 1) / chunk_len())
    expect = {"affinity_bank": 2 * chunks * chunk_len(), "affinity_propagate": 0,
              "bottleneck": sum(BOTTLENECK_LAUNCHES.values()) * (1 + chunks)}
    jf = check_outputs(save, tree / "Annotations" / "480p", {"clip": n}, "multimodel resnet50 + facebook")
    log(f"multimodel resnet50 + facebook: {n} frames in {wall:.3f} s = {n / wall:.3f} fps end to end, J&F {jf:.6f}, "
        f"launches {launches}")
    check(launches == expect, f"multimodel resnet50 + facebook: launches {expect}")
    return dict(fps=n / wall, seconds=wall, jf=jf, launches=launches)


def facebook_phase(torch, dev, work: Path, videos: dict):
    """Phase 12: the facebook model at full width (2048-wide layer4, 480p):
    (a) the encoder gate with its 8 bottleneck launches, and the TF32 flags
    left alone by its engines; (b) ``inference --model facebook`` then
    ``evaluation`` on the main path's tree, device ms per frame, card vs CPU
    masks; (c) multimodel with facebook second; (d) one lockstep chunk at
    facebook's lane cap at 480p and 1080p; (e) one full-width train step."""
    frames, label = load_video(work, "davis", "long", 4)
    res = {"encoder_min_cosine": encoder_phase(torch, dev, random_vosnet(torch, 0, "facebook"), frames[0])}
    net = calibrated_vosnet(torch, dev, 0, frames, "facebook")
    tf32_flags_kept(torch, dev, net, frames[:2], label)
    launches, fps, jf = main_path_phase(torch, dev, work, net, videos)
    res.update(main_path=dict(fps=fps, jf=jf, launches=launches))
    res["main_path"]["engine_ms_per_frame"] = engine_timing(torch, dev, net, work, "long", videos["long"])
    res["main_path"]["card_vs_cpu_agreement"] = small_clip_parity(torch, dev, net, work)
    res["multimodel"] = facebook_multimodel(torch, work, STRATEGY_FRAMES)
    res["memory"] = lockstep_memory(torch, dev, net, work, slopes=False)
    del net
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        steps, extra = training_steps(torch, dev, work, "facebook", TRAIN_RUNS[:1], fall_steps=0)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    res["train_step"] = dict(precision="cuDNN convolutions TF32 (PyTorch default), matmuls float32",
                             fwd_tflop=extra["fwd_tflop"], **steps["cross_entropy"])
    return res


def main() -> int:
    if not (ROOT / "semi_supervised_vos_tpu_torch" / "__init__.py").is_file():
        log("FAILED: the semi_supervised_vos_tpu_torch package is not beside this script")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    os.environ["SVOS_ZOO"] = "0"  # the train CLI's ImageNet lookup: random init, no download
    from semi_supervised_vos_tpu_torch.ops import _build

    dev = torch.device("cuda")
    # every float32 reference below runs in full float32 (cuDNN's default
    # for float32 convolutions would be TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} == (9, 0)")
    t0 = time.perf_counter()
    seconds = _build.build()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s (in parallel): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill", "smem")):
                log(f"  {name} ptxas: {line.strip()}")

    rng = np.random.default_rng(0)
    stage("phases 2-5: kernels")
    aff = affinity_phase(torch, dev, rng)
    prop = propagate_phase(torch, dev, rng)
    prob = probability_phase(torch, dev, rng)
    bott = bottleneck_phase(torch, dev, rng)

    videos = {"long": 56, "short": 9}
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        work = Path(tmp)
        make_davis_tree(work / "davis", videos, (H480, W480), seed=1)
        from PIL import Image

        frames = np.stack([np.asarray(Image.open(work / "davis" / "JPEGImages" / "480p" / "long" / f"{t:05d}.jpg"))
                           for t in range(4)])
        stage("phases 6-9: encoder, main path, kernel 3's path, strategies")
        encoder_phase(torch, dev, random_vosnet(torch, seed=0), frames[0])
        net = calibrated_vosnet(torch, dev, 0, frames)
        launches, fps, jf = main_path_phase(torch, dev, work, net, videos)
        engine_ms = engine_timing(torch, dev, net, work, "long", videos["long"])
        small_clip_parity(torch, dev, net, work)
        twenty_refs_run(torch, work, videos)
        make_davis_tree(work / "strategies", {"clip": STRATEGY_FRAMES}, (H480, W480), seed=2)
        prop_launches = propagate_path(torch, dev, net, work, "clip", STRATEGY_FRAMES)
        strategies = strategies_phase(torch, dev, work, net, calibrated_vosnet(torch, dev, 1, frames), STRATEGY_FRAMES)
        strategies_cpu_parity(torch, work)
        stage("phase 10: lockstep")
        lockstep_videos = {f"v{i}": 17 if i % 2 == 0 else 12 for i in range(8)}
        make_davis_tree(work / "lockstep", lockstep_videos, (H480, W480), seed=3)
        lockstep = {"cli": lockstep_cli(torch, work, lockstep_videos)}
        make_davis_tree(work / "lockstep2", {"v0": 17, "v1": 12}, (H480, W480), seed=4)
        lockstep["strategies"] = lockstep_strategies(torch, work, {"v0": 17, "v1": 12})
        lockstep["engine_ms_per_lane_frame"] = lockstep_engine_timing(torch, dev, net, work, lockstep_videos)
        lockstep["single_engine_ms_per_frame"] = engine_ms
        lockstep["kernels"] = lockstep_kernels(torch, dev, rng)
        lockstep["memory"] = lockstep_memory(torch, dev, net, work)
        stage("phase 11: training")
        training = training_phase(torch, dev, work)
        stage("phase 12: facebook")
        facebook = facebook_phase(torch, dev, work, videos)
    stage("summary")
    log(f"main path on {card}: {fps:.3f} fps end to end (CLI, decode and PNG writes included), "
        f"{engine_ms:.4f} ms/frame on the device (decoded frames), J&F {jf:.6f}")
    for name, r in strategies.items():
        log(f"strategy {name} on {card}: {r['fps']:.3f} fps end to end over {STRATEGY_FRAMES} frames, J&F {r['jf']:.6f}")
    lc = lockstep["cli"]
    log(f"lockstep on {card}: --video-batch 8 {lc['fps_vb8']:.3f} fps against --video-batch 1 {lc['fps_vb1']:.3f} fps "
        f"over {lc['frames']} frames; engine ms per lane-frame "
        + ", ".join(f"B={b} {ms:.4f}" for b, ms in lockstep["engine_ms_per_lane_frame"].items())
        + f" (single engine {engine_ms:.4f} ms/frame)")
    log(f"training on {card}: " + ", ".join(f"{k} {r['ms']:.3f} ms/step ({r['steps_per_s']:.3f} steps/s)"
                                            for k, r in training["steps"].items())
        + f"; train CLI {training['cli']['clips_per_s']:.3f} clips/s end to end, J&F after inference "
        f"{training['cli']['jf']:.6f}")
    fb, fb_step = facebook["main_path"], facebook["train_step"]
    log(f"facebook on {card}: main path {fb['fps']:.3f} fps end to end, {fb['engine_ms_per_frame']:.4f} ms/frame on "
        f"the device, J&F {fb['jf']:.6f}; multimodel with resnet50 {facebook['multimodel']['fps']:.3f} fps; train "
        f"step {fb_step['ms']:.3f} ms ({fb_step['steps_per_s']:.3f} steps/s), peak {fb_step['peak_share']:.4f} of the "
        "card; lane cap " + ", ".join(f"{k} {facebook['memory'][k]['cap_lanes']} lanes, peak "
                                      f"{facebook['memory'][k]['cap_share']:.4f} of the card" for k in ("480p", "1080p")))

    # launches: the main path's (kernel 3: its own path's); launches_by_path:
    # each strategy's run; prob_*: probability mode at 480p, where
    # scaled_dot_product_attention computes the same function
    by_path = {k: {name: r["launches"][k] for name, r in strategies.items()} for k in ("affinity_bank", "bottleneck")}
    for k in by_path:
        by_path[k]["lockstep single --video-batch 8"] = lc["launches_vb8"][k]
        for name, r in lockstep["strategies"].items():
            by_path[k][f"lockstep {name} --video-batch 2"] = r["launches"][k]
        by_path[k]["facebook single"] = fb["launches"][k]
        by_path[k]["multimodel resnet50 + facebook"] = facebook["multimodel"]["launches"][k]
    lk = lockstep["kernels"]
    prob_keys = dict(prob_bound_ms=prob["bound_ms"], prob_bound_by=prob["bound_by"], prob_library_ms=prob["library_ms"])
    kernels = [
        dict(name="affinity_bank", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/affinity_bank.cu",
             replaces="semi_supervised_vos_tpu/ops/affinity_pallas.py:355", launches=launches["affinity_bank"], **aff,
             prob_ms=prob["bank_ms"], **prob_keys, launches_by_path=by_path["affinity_bank"],
             **{key: lk[key] for key in lk if key.startswith("b8_")},
             launches_training=training["cli"]["launches"]["affinity_bank"]),
        dict(name="bottleneck", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/bottleneck.cu",
             replaces="semi_supervised_vos_tpu/ops/bottleneck_pallas.py:121", launches=launches["bottleneck"], **bott,
             launches_by_path=by_path["bottleneck"], n64_ms=lk["bottleneck_n64_ms"],
             n64_library_ms=lk["bottleneck_n64_library_ms"],
             launches_training=training["cli"]["launches"]["bottleneck"]),
        dict(name="affinity_propagate", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/affinity_bank.cu",
             replaces="semi_supervised_vos_tpu/ops/affinity_pallas.py:612", launches=prop_launches, **prop,
             prob_ms=prob["fused_ms"], **prob_keys,
             launches_training=training["cli"]["launches"]["affinity_propagate"]),
    ]
    print(json.dumps({"strategies": {name: dict(fps=r["fps"], seconds=r["seconds"], jf=r["jf"])
                                     for name, r in strategies.items()}}))
    print(json.dumps({"lockstep": lockstep}))
    print(json.dumps({"training": training}))
    print(json.dumps({"facebook": facebook}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
