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
     (e) one cross-entropy train step at bs 16 x 10 frames x 256^2;
 13. multi-device inference on a virtual mesh that names the one card n
     times (``parallel/mesh.py::make_mesh(devices=[cuda:0] * n)``): (a) the
     bank kernel in stats mode on 2, 4 and 8 row shards (the last ragged or
     padded past P), combined by ``distributed_softmax_combine``, against
     the unsharded kernel at 480p, B = 1 and 8, both timed; (b)
     ``ShardedPropagationEngine`` with 4 bank shards against the single
     engine on the main path's videos: n launches per frame, masks, device
     ms per frame of both; (c) the lockstep runner over a dp 2 x bank 2 mesh
     at ``--video-batch`` 3 (a padded video per group of 3) against the
     one-card lockstep CLI; (d) ``--bank-shards 1 --dp-shards 1`` through
     the CLI, and ``--bank-shards 2``: refused on one card with the JAX
     CLI's message, run and held to the one-card J&F on two or more;
 14. float32 inference (``SVOS_INFER_DTYPE=float32``): both float32
     kernels run tf32 ``wgmma`` (3xTF32; ``cuobjdump -sass``); (a) the
     float32 bank kernel (``csrc/affinity_bank_f32.cu``) against its plain
     version at 480p, B = 1 and 8, probability mode, a ragged P and K = 1,
     four stats shards combined against the unsharded kernel, timed beside
     the 3xTF32 and FFMA bounds and, in turns, float32
     ``scaled_dot_product_attention``; (b) the float32 bottleneck
     (``csrc/bottleneck_f32.cu``, weights split at fold time) against its
     plain version with TF32 off at 8 and 64 frames, in turns with three
     float32 cuDNN convolutions;
     (c) the float32 encoder of resnet50 and facebook against the float32
     module on the CPU; (d) the main path through the CLI: only the float32
     kernels launch, fps and engine ms/frame beside bf16's, card vs CPU
     masks; (e) ``--video-batch 8``, one resnet50 chunk at the float32 lane
     cap at 480p and 1080p, dp 2 x bank 2 on the virtual mesh; (f)
     ``SVOS_FAST_ENCODER=0``; (g) ``SVOS_PROFILE`` and ``SVOS_TRACE_DIR``;
 15. the native host loaders and training over a mesh: (a) the native
     mask upsampler (``csrc/host/upsample.cpp``) is on, the main path's
     PNGs are byte-equal with ``SVOS_NATIVE_UPSAMPLE=0`` and ``=1``, the
     JPEG decoder's state under ``SVOS_NATIVE_DECODE=1`` (its frames
     byte-equal to PIL's when it is on), host ms of decoding the main
     path's 65 frames and upsampling its masks both ways; (b) the mesh
     train step at full width (resnet50, bs 16 x 10 frames x 256^2) on a
     virtual mesh naming the card, DP 4 and data 2 x model 2, each beside
     the single-device step from the same weights and batch, TF32 off:
     loss within 1e-4 relative, the conv1 update's cosine >= 0.999, the
     largest BN running-statistic difference, ms a step (on one card the
     mesh's overhead, not a scaling) and peak memory under 0.85 of the
     card; (c) ``train --tp 2`` on ``[card] * 2`` for 2 epochs on phase
     11's tree, ``validation`` on its checkpoints over ``[card] * 2``, and
     ``parallel/dryrun.py::dryrun_multichip([card] * 4)``, with launches;
 16. wide frames and the last public names: (a) the float32 bank kernel
     against its plain version at hd 2 x wd 960 (B = 1 and 2, a prior too
     wide for its column table), a ragged 3 x 997 grid and two stats shards
     combined, 14a's 480p case timed again, B = 8 in probability mode in
     turns with float32 ``scaled_dot_product_attention``; (b) float32
     ``inference`` through the CLI on 8 frames of 32 x 7680 (feature grid
     4 x 960), its launches and its masks against the CPU's; (c) the
     flagship step (``graft_entry.py::entry``) on the card against the CPU
     (one ``affinity_propagate_fused`` launch a step), and
     ``bottleneck_stack`` over resnet50's layer3 against the plain stack in
     bf16 and float32;
 17. the port's two benches, each in a process of its own on the card at a
     reduced protocol: ``python -m semi_supervised_vos_tpu_torch.bench``
     (one pass, no strategy matrix, no train or 1080p pin) and
     ``.bench_train`` (one pass); their last JSON lines parsed, the
     kernel checks held to the gates above, the sharded engines' masks
     equal, both ``mfu`` in (0, 1].

Times are medians of 20 CUDA-event timings, printed with their p10-p90
spread. The line before the last is the card's name and power limit as
nvidia-smi reports them, the one before that a JSON summary of every
kernel, and before that JSON lines for the strategies, the lockstep phase,
training, facebook, the mesh phase, float32 and phases 15 to 17.
"""

from __future__ import annotations

import contextlib
import functools
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
PACKAGE = ROOT / "semi_supervised_vos_tpu_torch"
if (PACKAGE / "__init__.py").is_file():  # else main() says that the package is missing
    sys.path.insert(0, str(ROOT))
    from semi_supervised_vos_tpu_torch.utils.benchmarking import (
        PEAK_F32_FLOPS,
        PEAK_TF32_FLOPS,
        affinity_bound,
        bound,
        card_line,
        conv_flops,
        kernel_launches,
        time_ms,
        timing_keys,
    )
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


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


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
    b_ms, b_by = affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes)
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
    b_ms, b_by = affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes)
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
    res["bound_ms"], res["bound_by"] = affinity_bound(dev, k, p, wd, c, d, np.zeros(k), nbytes)
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


def engine_timing(torch, dev, net, work: Path, video: str, n: int, dtype=None):
    """Engine time per frame on the card with the frames already decoded
    (CUDA events around start_video + every chunk), at the compute ``dtype``
    (None: the card's default, bf16)."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    frames = np.stack([np.asarray(Image.open(work / "davis" / "JPEGImages" / "480p" / video / f"{t:05d}.jpg"))
                       for t in range(n)])
    label = np.asarray(Image.open(work / "davis" / "Annotations" / "480p" / video / "00000.png")).astype(np.int32)
    engine = PropagationEngine(net, (H480, W480), EngineConfig(compute_dtype=dtype), dev)
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
    log(f"{net.model} engine on the card ({engine.dtype}), decoded frames: {ms:.4f} ms/frame ({1000.0 / ms:.3f} fps) "
        f"over {n} frames")
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


_SMALL_CLIP_CPU_MASKS = {}  # id(net) -> the CPU engine's masks of the small clip


def small_clip_parity(torch, dev, net, work: Path, dtype=None, gate: float = 0.98):
    """Card (bf16 by default, both kernels) vs CPU (float32, golden) engine
    masks on the long video's first 12 frames shrunk to 120x214, past a ring
    wrap (frame_range 6): they differ only where bf16 (or, with ``dtype``
    float32, the summation order) moves a near-tie. The CPU masks of a
    network are computed once and reused."""
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    h, w, n = SMALL_CLIP
    frames, label = shrunk_clip(work, n, h, w)
    out = {}
    if id(net) in _SMALL_CLIP_CPU_MASKS:
        out["cpu"] = _SMALL_CLIP_CPU_MASKS[id(net)]
    for device in ("cpu", dev):
        if str(device) in out:
            continue
        cfg = EngineConfig(frame_range=6, compute_dtype=dtype if device == dev else None)
        engine = PropagationEngine(net, (h, w), cfg, device)
        state = engine.start_video(frames[0], label)
        masks, _ = engine.step_chunk_small(frames[1:], state, 1)
        out[str(device)] = masks.cpu().numpy()
    _SMALL_CLIP_CPU_MASKS[id(net)] = out["cpu"]
    net.to(dev)
    agree = float((out["cpu"] == out[str(dev)]).mean())
    classes = np.unique(out["cpu"]).tolist()
    log(f"small clip {h}x{w}, {n} frames, {net.model}, card {dtype or torch.bfloat16}: CPU mask classes {classes}, "
        f"card vs CPU mask agreement {agree:.6f}")
    check(classes == [0, 1, 2], f"{net.model}: the CPU engine's masks carry both objects")
    check(agree >= gate, f"{net.model}: card masks agree with the CPU engine on >= {gate:.1%} of pixels")
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
    reset_kernel_launches()
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
    launches = kernel_launches()
    agree = (torch.stack(masks) == engine_masks).double().mean().item()
    classes = torch.unique(torch.stack(masks)).tolist()
    log(f"affinity_propagate_fused path: {n - 1} frames in {wall:.3f} s, launches {launches}, "
        f"mask classes {classes}, agreement with the engine's masks {agree:.6f}")
    check(launches == launch_counts(affinity_propagate=n - 1),
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

    reset_kernel_launches()
    t0 = time.perf_counter()
    cli(args, standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, kernel_launches()


@contextlib.contextmanager
def infer_dtype(dtype: str, **env):
    """``SVOS_INFER_DTYPE`` (and any other variables given) set for the
    enclosed CLI runs, restored after."""
    env = {"SVOS_INFER_DTYPE": dtype, **env}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
        expect = launch_counts(affinity_bank=streams * propagated, bottleneck=11 * streams * (1 + chunks))
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


def lockstep_launches(engines, t_max: int, dtype: str = "bfloat16") -> dict:
    """Launches of one lockstep group of resnet50 engines ``(frame_hw,
    lanes)`` at the compute ``dtype`` (the kernels of that dtype): one
    bank-kernel launch per engine and step (the last chunk padded to a whole
    chunk), 11 bottleneck launches per encode call (the start, then each
    chunk's frames in calls of at most the lane cap)."""
    import torch

    from semi_supervised_vos_tpu_torch.infer.batched import _hbm_lanes_cap
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    chunk = chunk_len()
    chunks = math.ceil((t_max - 1) / chunk)
    cap = {hw: _hbm_lanes_cap(hw, "resnet50", getattr(torch, dtype)) for hw, _ in engines}
    encodes = sum(1 + chunks * math.ceil(chunk / max(1, cap[hw] // b)) for hw, b in engines)
    suffix = "_f32" if dtype == "float32" else ""
    return launch_counts(**{f"affinity_bank{suffix}": len(engines) * chunks * chunk, f"bottleneck{suffix}": 11 * encodes})


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
        b1_ms, by = affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes)
        b1_prob, by_prob = affinity_bound(dev, k, p, wd, c, d, np.zeros(k), nbytes)
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


def lockstep_memory(torch, dev, net, work: Path, slopes: bool = True, dtype=None):
    """10d (12d for facebook, 14e at float32): peak device memory of one
    chunk (start_videos + one 8-step chunk) at 480p (B = 1, 8) and 1080p
    (B = 1, 2), the bytes per lane (with ``slopes``), and one chunk at
    ``_hbm_lanes_cap`` lanes for ``net``'s model and the compute ``dtype``
    (None: bf16) at each resolution, which must stay under 85 % of the
    card's memory (the anchors of ``infer/batched.py`` aim it at 70 %)."""
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
        engine = BatchedPropagationEngine(net, hw, b, EngineConfig(compute_dtype=dtype), dev)
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
        lanes = _hbm_lanes_cap(hw, net.model, dtype or torch.bfloat16)
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
        log(f"lockstep memory {net.model} {name} {dtype or torch.bfloat16}: " + msg)
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


LAUNCH_KEYS = ("affinity_bank", "affinity_propagate", "bottleneck", "affinity_bank_f32", "bottleneck_f32")


def launch_counts(**counts) -> dict:
    """Expected launch counts: the named ones, 0 for every other kernel."""
    return {key: counts.get(key, 0) for key in LAUNCH_KEYS}


def reset_kernel_launches():
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    aff.affinity_from_bank_batched.launches = aff.affinity_propagate_fused.launches = 0
    bottleneck_block.launches = 0
    aff.affinity_from_bank_batched.launches_f32 = bottleneck_block.launches_f32 = 0


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
    fwd_flops = conv_flops(net, x)
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
    check(launches == launch_counts(), "no hand-written kernel runs on the training path")
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
    expect = launch_counts(affinity_bank=2 * chunks * chunk_len(),
                           bottleneck=sum(BOTTLENECK_LAUNCHES.values()) * (1 + chunks))
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



# ---- phase 13: multi-device inference on a virtual one-card mesh -----------


def virtual_mesh(torch, dev, n_data: int, n_model: int):
    """A mesh that names the one card ``n_data x n_model`` times: every shard
    runs, with its row offsets and the combine, on the same card."""
    from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_data, n_model, devices=[dev] * (n_data * n_model))


def sharded_kernels(torch, dev, rng):
    """13a: the bank kernel in stats mode on n row shards (row_base s x
    P_loc, the last one padded to P_loc past P where n does not divide P),
    combined by ``distributed_softmax_combine`` (the combine kernel), against
    the unsharded kernel at 480p (K 9, P 6420, C 256), B = 1 and 8; both
    timed, the n launches and the combine together."""
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine

    c, d, d_pad, cap, k = 256, 22, 24, 45, 9
    hd, wd = out_spatial(H480, W480)
    p = hd * wd
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    res = {}
    for b, shard_counts in ((1, (2, 4, 8)), (8, (2, 4))):
        feats = (torch.randn((cap, b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16)
        labels = torch.nn.functional.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev), d_pad)
        labels = labels.to(torch.bfloat16)
        tgt = (torch.randn((b, p, c), generator=gen, device=dev) * 0.2).to(torch.bfloat16).float()
        run_whole = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)  # noqa: E731
        whole = run_whole()[:, :d]
        whole_ms = time_ms(run_whole)
        for n in shard_counts:
            p_loc = -(-p // n)
            pad = torch.nn.functional.pad
            shards = [(pad(feats[:, :, s * p_loc : (s + 1) * p_loc], (0, 0, 0, p_loc - min(p_loc, p - s * p_loc)))
                       .contiguous(),
                       pad(labels[:, :, s * p_loc : (s + 1) * p_loc], (0, 0, 0, p_loc - min(p_loc, p - s * p_loc)))
                       .contiguous()) for s in range(n)]

            def run_sharded():
                stats = [aff.affinity_from_bank_batched(f, lab, tgt, slots, row_base=s * p_loc, return_stats=True,
                                                        **kw) for s, (f, lab) in enumerate(shards)]
                return distributed_softmax_combine(*zip(*stats))

            got = run_sharded()[:, :d]
            max_abs = (got - whole).abs().max().item()
            agree = (got.argmax(1) == whole.argmax(1)).double().mean().item()
            ms = time_ms(run_sharded)
            log(f"13a B={b} {n} shards of {p_loc} rows (last {p - (n - 1) * p_loc} real): max_abs vs the unsharded "
                f"kernel {max_abs:.3e}, argmax agreement {agree}; {n} launches + combine {ms:.4f} ms, unsharded "
                f"{whole_ms:.4f} ms")
            check(max_abs <= STATS_GATE and agree == 1.0,
                  f"B={b}, {n} stats shards combined vs the unsharded kernel <= {STATS_GATE} / 1.0")
            res[f"b{b}_shards{n}"] = dict(max_abs_err=max_abs, argmax_agreement=agree, ms=ms, unsharded_ms=whole_ms)
        del feats, labels, tgt, shards
    return res


def run_engine(torch, engine, frames, label):
    """One video through an engine's chunk path: (N - 1, hd, wd) masks."""
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    state = engine.start_video(frames[0], label)
    chunk = chunk_len()
    out = []
    for s in range(1, len(frames), chunk):
        masks, state = engine.step_chunk_small(frames[s : s + chunk], state, s)
        out.append(masks)
    return torch.cat(out).cpu().numpy()


def sharded_engine(torch, dev, net, work: Path, videos: dict, n: int = 4):
    """13b: ``ShardedPropagationEngine`` with n bank shards against the
    single engine on the main path's videos: launches (n per propagated
    frame), mask agreement, and device ms per frame of both on the long
    video, timed in turns (single, sharded, sharded, single), second runs."""
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine

    cfg = EngineConfig()
    single = PropagationEngine(net, (H480, W480), cfg, dev)
    sharded = ShardedPropagationEngine(net, (H480, W480), cfg, virtual_mesh(torch, dev, 1, n))
    clips = {v: load_video(work, "davis", v, t) for v, t in videos.items()}
    reset_kernel_launches()
    got = {v: run_engine(torch, sharded, *clips[v]) for v in videos}
    torch.cuda.synchronize()
    launches = kernel_launches()
    same = total = 0
    for v in videos:
        expect = run_engine(torch, single, *clips[v])
        same += int((got[v] == expect).sum())
        total += expect.size
    agree = same / total
    propagated = sum(videos.values()) - len(videos)
    encodes = sum(1 + math.ceil((t - 1) / chunk_len()) for t in videos.values())
    log(f"13b sharded engine, {n} bank shards of {sharded.p_loc} rows: launches {launches}, mask agreement with the "
        f"single engine {agree:.7f}")
    check(launches == launch_counts(affinity_bank=n * propagated, bottleneck=11 * encodes),
          f"{n} bank-kernel launches per propagated frame ({n} x {propagated}), 11 bottleneck launches per encode")
    check(agree >= 0.995, "sharded engine masks agree with the single engine on >= 99.5% of pixels")
    frames, label = clips["long"]
    times = {}
    for name, engine in (("single", single), ("sharded", sharded), ("sharded", sharded), ("single", single)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        run_engine(torch, engine, frames, label)
        end.record()
        end.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end) / len(frames))
    ms = {name: t[1] for name, t in times.items()}
    log(f"13b on decoded frames, {len(frames)} frames: single engine {ms['single']:.4f} ms/frame, {n}-shard engine "
        f"{ms['sharded']:.4f} ms/frame ({ms['sharded'] / ms['single']:.3f}x; turns single, sharded, sharded, "
        f"single: " + ", ".join(f"{t:.4f}" for t in times["single"][:1] + times["sharded"] + times["single"][1:])
        + ")")
    return dict(shards=n, p_loc=sharded.p_loc, launches=launches, agreement=agree,
                single_ms_per_frame=ms["single"], sharded_ms_per_frame=ms["sharded"])


def mesh_lockstep(torch, dev, work: Path, videos: dict, n_data: int = 2, n_bank: int = 2, video_batch: int = 3,
                  dtype: str = "bfloat16"):
    """13c (14e at float32): the lockstep runner
    (``infer/batched.py::inference_batched``) over a dp ``n_data`` x bank
    ``n_bank`` mesh at ``video_batch`` videos a group (groups of 3 pad to 4
    videos over the two data rows) at the compute ``dtype``, against
    ``--video-batch`` of the one-card engine through the CLI."""
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import batched
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    tree, ckpt = work / "lockstep", work / "resnet50.pth.tar"
    save_one = work / f"mesh_vb_one_card_{dtype}"
    with infer_dtype(dtype):
        cli_run(torch, ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save_one), "--video-batch",
                        str(video_batch)])
    net = load_torch_checkpoint(ckpt, VOSNet("resnet50"))
    dataset = InferenceDataset(str(tree / "JPEGImages" / "480p"), inference_strategy="single")
    save = work / f"mesh_vb_{dtype}"
    mesh = virtual_mesh(torch, dev, n_data, n_bank)
    reset_kernel_launches()
    t0 = time.perf_counter()
    batched.inference_batched(dataset, tree / "Annotations" / "480p", save, net,
                              EngineConfig(compute_dtype=getattr(torch, dtype)), dev, video_batch, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    names = sorted(videos)
    groups = [names[i : i + video_batch] for i in range(0, len(names), video_batch)]
    chunk = chunk_len()
    bank = bottleneck = 0
    for g in groups:
        t_max = max(videos[v] for v in g)
        steps = math.ceil((t_max - 1) / chunk) * chunk
        per_row = -(-len(g) // n_data)
        calls_per_chunk = math.ceil(chunk / max(1, batched._hbm_lanes_cap((H480, W480), "resnet50",
                                                                          getattr(torch, dtype)) // per_row))
        bank += steps * n_data * n_bank
        bottleneck += 11 * n_data * (1 + math.ceil((t_max - 1) / chunk) * calls_per_chunk)
    agree = png_agreement(save, save_one, videos, "mesh lockstep")
    suffix = "_f32" if dtype == "float32" else ""
    log(f"lockstep over dp {n_data} x bank {n_bank} (virtual mesh), {dtype}, --video-batch {video_batch} on "
        f"{len(videos)} videos ({len(groups)} groups): {wall:.3f} s, launches {launches}, mask agreement with the "
        f"one-card --video-batch {video_batch} {agree:.7f}")
    check(launches == launch_counts(**{f"affinity_bank{suffix}": bank, f"bottleneck{suffix}": bottleneck}),
          f"mesh lockstep: {n_data * n_bank} bank-kernel launches per step ({bank}), {bottleneck} bottleneck launches")
    check(agree >= 0.995, "mesh lockstep masks agree with the one-card lockstep engine on >= 99.5% of pixels")
    return dict(launches=launches, agreement=agree, seconds=wall, groups=len(groups))


def mesh_cli(torch, work: Path):
    """13d: the CLI's shard options. ``--bank-shards 1 --dp-shards 1`` runs;
    on one card ``--bank-shards 2`` exits with the JAX CLI's message; on two
    or more it runs and its J&F matches the one-card run's."""
    import click

    tree, ckpt = work / "strategies", work / "resnet50.pth.tar"
    gt = tree / "Annotations" / "480p"
    base = ["inference", "-d", str(tree), "-r", str(ckpt)]
    wall, launches = cli_run(torch, base + ["-s", str(work / "mesh_cli_1"), "--bank-shards", "1", "--dp-shards", "1"])
    jf1 = check_outputs(work / "mesh_cli_1", gt, {"clip": STRATEGY_FRAMES}, "--bank-shards 1 --dp-shards 1")
    check(launches["affinity_bank"] == STRATEGY_FRAMES - 1, "--bank-shards 1: one bank-kernel launch per frame")
    res = dict(cards=torch.cuda.device_count(), jf_one_card=jf1)
    if torch.cuda.device_count() < 2:
        try:
            cli_run(torch, base + ["-s", str(work / "mesh_cli_2"), "--bank-shards", "2"])
        except click.ClickException as err:
            message = err.format_message()
        else:
            message = None
        expect = "--dp-shards 1 x --bank-shards 2 exceeds the 1 available device(s)."
        log(f"13d one card: --bank-shards 1 --dp-shards 1 ran (J&F {jf1:.6f}); --bank-shards 2 refused: {message!r}")
        check(message == expect, f"--bank-shards 2 on one card exits with {expect!r}")
        res["case"] = "one card: --bank-shards 2 refused"
        return res
    wall2, launches2 = cli_run(torch, base + ["-s", str(work / "mesh_cli_2"), "--bank-shards", "2"])
    jf2 = check_outputs(work / "mesh_cli_2", gt, {"clip": STRATEGY_FRAMES}, "--bank-shards 2")
    agree = png_agreement(work / "mesh_cli_2", work / "mesh_cli_1", {"clip": STRATEGY_FRAMES}, "--bank-shards 2")
    log(f"13d {torch.cuda.device_count()} cards: --bank-shards 2 {wall2:.3f} s, launches {launches2}, J&F {jf2:.6f} "
        f"(one card {jf1:.6f}), mask agreement {agree:.7f}")
    check(launches2["affinity_bank"] == 2 * (STRATEGY_FRAMES - 1), "--bank-shards 2: two launches per frame")
    check(agree >= 0.995 and abs(jf2 - jf1) <= 0.005, "--bank-shards 2 on two cards: masks and J&F match one card's")
    res.update(case="several cards: --bank-shards 2 ran", jf_two_cards=jf2, agreement=agree, launches=launches2)
    return res


def mesh_phase(torch, dev, rng, work: Path, net, videos: dict, lockstep_videos: dict):
    """Phase 13: multi-device inference on a virtual one-card mesh."""
    return {"kernels": sharded_kernels(torch, dev, rng), "engine": sharded_engine(torch, dev, net, work, videos),
            "lockstep": mesh_lockstep(torch, dev, work, lockstep_videos), "cli": mesh_cli(torch, work)}


# ---- phase 14: float32 inference (SVOS_INFER_DTYPE=float32) ----------------


def f32_bank_inputs(torch, gen, b: int, p: int, c: int = 256, d: int = 22, d_pad: int = 24, cap: int = 45):
    """A float32 bank (cap, b, p, c) with one-hot bf16 labels of d classes
    in d_pad columns, and a (b, p, c) target, drawn on the card from
    ``gen``."""
    import torch.nn.functional as F

    dev = gen.device
    feats = torch.randn((cap, b, p, c), generator=gen, device=dev) * 0.2
    labels = F.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev), d_pad).to(torch.bfloat16)
    return feats, labels, torch.randn((b, p, c), generator=gen, device=dev) * 0.2


def f32_bank_compare(label: str, got, expect, gate: float = AFFINITY_GATE, d: int = 22) -> float:
    """The float32 bank kernel's gate: max_abs over the d classes <= gate
    and the argmax everywhere; returns max_abs."""
    got, expect = got[..., :d, :], expect[..., :d, :]
    max_abs = (got - expect).abs().max().item()
    agree = (got.argmax(-2) == expect.argmax(-2)).double().mean().item()
    log(f"{label}: max_abs={max_abs:.3e} argmax_agreement={agree}")
    check(max_abs <= gate and agree == 1.0, f"{label} <= {gate} / 1.0")
    return max_abs


def f32_bank_kernel(torch, dev, rng):
    """14a: the float32 bank kernel (``csrc/affinity_bank_f32.cu``) against
    its plain version at 480p (K 9, P 6420, C 256, float32 bank, bf16
    labels): B = 1 with the prior and in probability mode, B = 8 lane by
    lane, a ragged P and K = 1; four float32 stats shards combined against
    the unsharded kernel; timed against the 3xTF32 and FFMA bounds, and in
    probability mode in turns with float32 ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine

    c, d, d_pad, cap, k, hd, wd = 256, 22, 24, 45, 9, 60, 107
    p = hd * wd
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    make = functools.partial(f32_bank_inputs, torch, gen)
    compare = lambda name, got, expect, gate=AFFINITY_GATE: f32_bank_compare(  # noqa: E731
        f"14a float32 bank kernel {name}", got, expect, gate)

    feats8, labels8, tgt8 = make(8, p)
    feats, labels, tgt = feats8[:, :1].contiguous(), labels8[:, :1].contiguous(), tgt8[:1].contiguous()
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    before = aff.affinity_from_bank_batched.launches
    worst = 0.0
    for spatial in (True, False):
        got = aff.affinity_from_bank_batched(feats, labels, tgt, slots, spatial=spatial, **kw)
        expect = aff.affinity_from_bank_plain(feats, labels, tgt, slots, spatial=spatial, **kw)
        worst = max(worst, compare(f"480p B=1 {'prior on' if spatial else 'probability mode'}", got, expect))
    got8 = aff.affinity_from_bank_batched(feats8, labels8, tgt8, slots, **kw)
    expect8 = torch.cat([aff.affinity_from_bank_plain(feats8[:, i : i + 1], labels8[:, i : i + 1], tgt8[i : i + 1],
                                                      slots, **kw) for i in range(8)])
    worst = max(worst, compare("480p B=8", got8, expect8))
    del expect8
    for name, (eh, ew), eslots, evalid, edense in (("13x27 ragged P", (13, 27), slots, valid, dense),
                                                   ("K=1", (16, 20), slots[:1], [True], [True])):
        fe, la, ta = make(1, eh * ew)
        ekw = dict(feature_hw=(eh, ew), temperature=1.0, valid=evalid, dense=edense)
        worst = max(worst, compare(name, aff.affinity_from_bank_batched(fe, la, ta, eslots, **ekw),
                                   aff.affinity_from_bank_plain(fe, la, ta, eslots, **ekw)))
    check(aff.affinity_from_bank_batched.launches == before, "float32 banks launch no bf16 bank kernel")

    # four float32 stats shards of 1605 rows, combined
    n = 4
    p_loc = -(-p // n)
    shards = [(feats[:, :, s * p_loc : (s + 1) * p_loc].contiguous(), labels[:, :, s * p_loc : (s + 1) * p_loc]
               .contiguous()) for s in range(n)]

    def run_sharded():
        stats = [aff.affinity_from_bank_batched(f, lab, tgt, slots, row_base=s * p_loc, return_stats=True, **kw)
                 for s, (f, lab) in enumerate(shards)]
        return distributed_softmax_combine(*zip(*stats))

    whole = aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
    compare(f"{n} stats shards + combine vs the unsharded kernel", run_sharded(), whole, STATS_GATE)

    # times at 480p, beside the 3xTF32 bound (three tf32 products of the
    # similarity, the bf16 hi / lo label product, the exps, the bytes), the
    # FFMA bound and the plain version
    _, inv_sigma2, _ = aff.slot_table(slots, valid, dense, 8.0, 21.0, True)
    nbytes = k * p * (c * 4 + d_pad * 2) + p * c * 4 + d_pad * p * 4
    b_ms, b_by = affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes, PEAK_TF32_FLOPS, products=3)
    prob_b_ms, prob_b_by = affinity_bound(dev, k, p, wd, c, d, np.zeros(k), nbytes, PEAK_TF32_FLOPS,
                                          products=3)
    ffma_ms, _ = affinity_bound(dev, k, p, wd, c, d, inv_sigma2, nbytes, PEAK_F32_FLOPS)
    run = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)  # noqa: E731
    ms_turns = [time_ms(run)]
    plain_ms = time_ms(lambda: aff.affinity_from_bank_plain(feats, labels, tgt, slots, **kw))
    b8_ms = time_ms(lambda: aff.affinity_from_bank_batched(feats8, labels8, tgt8, slots, **kw), reps=10)
    sharded_ms = time_ms(run_sharded)
    ms_turns.append(time_ms(run))
    ms = min(ms_turns, key=float)
    run_prob = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, spatial=False, **kw)  # noqa: E731
    # probability mode: float32 attention over the valid slots' rows
    sel = torch.as_tensor(slots[valid], device=dev)
    q, keys = tgt[:, None], feats[sel, 0].reshape(1, 1, -1, c)
    values = labels[sel, 0].float().reshape(1, 1, -1, d_pad)
    run_library = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)  # noqa: E731
    expect = aff.affinity_from_bank_plain(feats, labels, tgt, slots, spatial=False, **kw)[0, :d]
    sdpa_err = (run_library()[0, 0, :, :d].T - expect).abs().max().item()
    check(sdpa_err <= SDPA_GATE, f"float32 scaled_dot_product_attention agrees with the plain version <= {SDPA_GATE}")
    # kernel and library in turns: kernel, library, library, kernel
    turns = [time_ms(run_prob), time_ms(run_library), time_ms(run_library), time_ms(run_prob)]
    prob_ms, library_ms = min(turns[0], turns[3], key=float), min(turns[1], turns[2], key=float)
    log(f"14a float32 bank kernel 480p: B=1 {ms_turns[0]:.4f} / {ms_turns[1]:.4f} ms, plain {plain_ms:.4f} ms, "
        f"3xTF32 bound {b_ms:.4f} ms ({b_by}), FFMA bound {ffma_ms:.4f} ms; B=8 {b8_ms:.4f} ms; {n} stats shards + "
        f"combine {sharded_ms:.4f} ms; probability mode {turns[0]:.4f} / {turns[3]:.4f} ms, float32 "
        f"scaled_dot_product_attention {turns[1]:.4f} / {turns[2]:.4f} ms (max_abs vs plain {sdpa_err:.3e}), "
        f"bound {prob_b_ms:.4f} ms; kernel / library {prob_ms / library_ms:.3f}; kernel / FFMA bound "
        f"{ms / ffma_ms:.3f}")
    del feats8, labels8, tgt8, got8
    return dict(max_abs_err=worst, **timing_keys("ms", ms), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                ffma_bound_ms=ffma_ms, library_ms=None, b8_ms=b8_ms, b8_bound_ms=8 * b_ms, stats4_ms=sharded_ms,
                prob_ms=prob_ms, prob_bound_ms=prob_b_ms, prob_bound_by=prob_b_by, prob_library_ms=library_ms)


def f32_bottleneck_kernel(torch, dev, rng):
    """14b: the float32 bottleneck kernel (``csrc/bottleneck_f32.cu``)
    against its plain version (TF32 off) at both 480p geometries, 8 and 64
    frames, timed beside three float32 cuDNN convolutions (TF32 off); the
    per-call sums are those of one resnet50 encode call (3 blocks at C 512,
    8 at C 1024)."""
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.ops.bottleneck import (bottleneck_block, bottleneck_block_plain,
                                                              tf32_split_weights)

    def library_block(x, k1, b1, k2, b2, k3, b3):
        y = torch.relu(F.conv2d(x, k1, b1))
        y = torch.relu(F.conv2d(y, k2, b2, padding=1))
        return torch.relu(F.conv2d(y, k3, b3) + x)

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "14b runs with TF32 off")
    h, w = 60, 107
    worst = 0.0
    per_call = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ffma_bound_ms=0.0) for n in (8, 64)}
    by = None
    before = bottleneck_block.launches
    for cc, c4, blocks in ((512, 128, 3), (1024, 256, 8)):
        for n in (8, 64):
            x = torch.as_tensor(rng.standard_normal((n, h, w, cc)), dtype=torch.float32).to(dev)
            shapes = [(cc, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, cc), (cc,)]
            scales = [math.sqrt(2 / cc), 0.1, math.sqrt(2 / (9 * c4)), 0.1, math.sqrt(2 / c4), 0.1]
            wts = [torch.as_tensor(rng.standard_normal(sh) * sc, dtype=torch.float32).to(dev)
                   for sh, sc in zip(shapes, scales)]
            planes = tf32_split_weights(wts[0], wts[2], wts[4])  # as a folded table holds them
            got = bottleneck_block(x, *wts, planes=planes)
            expect = bottleneck_block_plain(x, *wts)
            rel = ((got - expect).abs().max() / expect.abs().max()).item()
            worst = max(worst, (got - expect).abs().max().item())
            check(torch.equal(bottleneck_block(x, *wts), got), "float32 bottleneck: planes made per call or at fold "
                  "time give the same output")
            del got, expect
            xl = x.permute(0, 3, 1, 2)
            lib = [wts[0].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[1],
                   wts[2].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), wts[3],
                   wts[4].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[5]]
            reps = 20 if n == 8 else 5
            run = lambda: bottleneck_block(x, *wts, planes=planes)  # noqa: E731
            run_library = lambda: library_block(xl, *lib)  # noqa: E731
            # kernel and library in turns: kernel, library, library, kernel
            turns = [time_ms(run, reps=reps), time_ms(run_library, reps=reps), time_ms(run_library, reps=reps),
                     time_ms(run, reps=reps)]
            ms, library_ms = min(turns[0], turns[3], key=float), min(turns[1], turns[2], key=float)
            plain_ms = time_ms(lambda: bottleneck_block_plain(x, *wts), reps=reps)
            ops = 2.0 * n * h * w * (cc * c4 + 9 * c4 * c4 + c4 * cc)
            nbytes = 4 * (2 * n * h * w * cc + 2 * cc * c4 + 9 * c4 * c4 + 2 * c4 + cc)
            b_ms, b_by = bound(3 * ops, nbytes, peak=PEAK_TF32_FLOPS)  # 3xTF32: three tf32 products
            ffma_ms, _ = bound(ops, nbytes, peak=PEAK_F32_FLOPS)
            by = b_by if (cc, n) == (1024, 8) else by
            log(f"14b float32 bottleneck N={n} C={cc} C4={c4}: max_abs/max_ref={rel:.3e}; kernel {turns[0]:.4f} / "
                f"{turns[3]:.4f} ms, plain {plain_ms:.4f} ms, three float32 cuDNN convolutions {turns[1]:.4f} / "
                f"{turns[2]:.4f} ms, 3xTF32 bound {b_ms:.4f} ms ({b_by}), FFMA bound {ffma_ms:.4f} ms")
            check(rel <= 1e-4, f"float32 bottleneck N={n} C={cc}: max error <= 1e-4 of the largest output")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bound_ms", b_ms),
                           ("ffma_bound_ms", ffma_ms)):
                per_call[n][key] += blocks * v
            del x, xl
    check(bottleneck_block.launches == before, "float32 activations launch no bf16 bottleneck kernel")
    c8, c64 = per_call[8], per_call[64]
    log(f"14b float32 bottleneck per resnet50 encode call (11 launches): N=8 kernel {c8['ms']:.4f} ms, plain "
        f"{c8['plain_ms']:.4f} ms, library {c8['library_ms']:.4f} ms, 3xTF32 bound {c8['bound_ms']:.4f} ms, FFMA "
        f"bound {c8['ffma_bound_ms']:.4f} ms; N=64 kernel {c64['ms']:.4f} ms, library {c64['library_ms']:.4f} ms, "
        f"bound {c64['bound_ms']:.4f} ms; kernel / library {c8['ms'] / c8['library_ms']:.3f} (N=8), "
        f"{c64['ms'] / c64['library_ms']:.3f} (N=64)")
    return dict(max_abs_err=worst, bound_by=by, **c8, n64_ms=c64["ms"], n64_library_ms=c64["library_ms"],
                n64_bound_ms=c64["bound_ms"])


def f32_encoder(torch, dev, arch: str, frame_u8) -> float:
    """14c: the BN-folded float32 encoder on the card (the float32 bottleneck
    kernel, 11 launches for resnet50 and 8 for facebook, nothing of the bf16
    kernel) against the float32 module on the CPU, one 480x854 frame, with
    the JAX package's recipe (perturbed BN statistics): min per-pixel cosine
    >= 0.99999."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.infer_fast import fast_encode

    net = random_vosnet(torch, 0, arch)
    x = torch.tensor(frame_u8[None]).float() / 255.0
    x = (x - torch.as_tensor(IMAGENET_MEAN)) / torch.as_tensor(IMAGENET_STD)
    with torch.no_grad():
        ref = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        net.to(dev)
        table = fold_vosnet(net, torch.float32)
        reset_kernel_launches()
        fast = fast_encode(table, x.to(dev), torch.float32, arch=arch).cpu()
        launches = kernel_launches()
    cos = torch.nn.functional.cosine_similarity(fast.reshape(-1, 256), ref.reshape(-1, 256), dim=-1).min().item()
    log(f"14c float32 encoder {arch} 480x854 on the card vs the float32 module on the CPU: min per-pixel cosine "
        f"{cos:.7f}, launches {launches}")
    check(bool(torch.isfinite(fast).all()) and cos >= 0.99999, f"{arch} float32 encoder min cosine >= 0.99999")
    check(launches == launch_counts(bottleneck_f32=BOTTLENECK_LAUNCHES[arch]),
          f"{BOTTLENECK_LAUNCHES[arch]} float32 bottleneck launches per {arch} encode, no bf16 kernel")
    return cos


def f32_main_path(torch, dev, work: Path, net, videos: dict, bf16: dict):
    """14d: ``inference`` under ``SVOS_INFER_DTYPE=float32`` on the main
    path's tree (only the float32 kernels launch), its masks beside phase
    7's bf16 masks; fps and the engine's device ms per frame beside bf16's
    (``bf16``, measured earlier in this run); card vs CPU masks on the small
    clip (>= 0.995), with bf16's figure beside."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    save = work / "pred_f32"
    with infer_dtype("float32"):
        wall, launches = cli_run(torch, ["inference", "-d", str(work / "davis"), "-r", str(work / "resnet50.pth.tar"),
                                         "-s", str(save)])
    n_frames = sum(videos.values())
    encodes = sum(1 + math.ceil((n - 1) / chunk_len()) for n in videos.values())
    vs_bf16 = png_agreement(save, work / "pred_resnet50", videos, "float32 main path")
    for video, n in videos.items():
        classes = sorted(set().union(*(np.unique(np.asarray(Image.open(save / video / f"{t:05d}.png"))).tolist()
                                       for t in range(1, n))))
        check(classes == [0, 1, 2], f"float32 main path {video}: the predicted masks carry both objects ({classes})")
    log(f"14d float32 main path: {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} fps end to end (bf16 "
        f"{bf16['fps']:.3f}), masks agree with bf16's on {vs_bf16:.6f} of pixels, launches {launches}")
    check(launches == launch_counts(affinity_bank_f32=n_frames - len(videos), bottleneck_f32=11 * encodes),
          f"float32 main path: {n_frames - len(videos)} float32 bank and {11 * encodes} float32 bottleneck "
          "launches, none of the bf16 kernels")
    ms = engine_timing(torch, dev, net, work, "long", videos["long"], torch.float32)
    agree = small_clip_parity(torch, dev, net, work, torch.float32, gate=0.995)
    log(f"14d float32 engine {ms:.4f} ms/frame against bf16 {bf16['engine_ms']:.4f}; card vs CPU masks {agree:.6f} "
        f"(bf16 {bf16['card_vs_cpu']:.6f})")
    return dict(fps=n_frames / wall, seconds=wall, agreement_with_bf16=vs_bf16, launches=launches,
                engine_ms_per_frame=ms, card_vs_cpu_agreement=agree, bf16_fps=bf16["fps"],
                bf16_engine_ms_per_frame=bf16["engine_ms"], bf16_card_vs_cpu_agreement=bf16["card_vs_cpu"])


def f32_lockstep(torch, dev, work: Path, net, videos: dict):
    """14e: ``--video-batch 8`` under ``SVOS_INFER_DTYPE=float32`` on the
    lockstep tree (one float32 bank-kernel launch a step) against
    ``--video-batch 1``; one resnet50 chunk at the float32 lane cap at 480p
    and 1080p under 85 % of the card (facebook's float32 anchors:
    ``prof_torch/lane_caps.py``); dp 2 x bank 2 on the virtual mesh at
    float32."""
    tree, ckpt = work / "lockstep", work / "resnet50.pth.tar"
    saves = {vb: work / f"lockstep_f32_vb{vb}" for vb in (8, 1)}
    walls, launches = {}, {}
    with infer_dtype("float32"):
        for vb, save in saves.items():
            walls[vb], launches[vb] = cli_run(torch, ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save),
                                                      "--video-batch", str(vb)])
    expect = lockstep_launches([((H480, W480), 8)], max(videos.values()), "float32")
    agree = png_agreement(saves[8], saves[1], videos, "float32 --video-batch 8 vs 1")
    n_frames = sum(videos.values())
    log(f"14e float32 --video-batch 8: {n_frames} frames in {walls[8]:.3f} s = {n_frames / walls[8]:.3f} fps "
        f"(--video-batch 1 {n_frames / walls[1]:.3f} fps), launches {launches[8]}, mask agreement with --video-batch 1 "
        f"{agree:.7f}")
    check(launches[8] == expect, f"float32 --video-batch 8: launches {expect}")
    check(agree >= 0.999, "float32 --video-batch 8 masks agree with --video-batch 1 on >= 99.9% of pixels")
    res = dict(fps_vb8=n_frames / walls[8], fps_vb1=n_frames / walls[1], launches_vb8=launches[8], agreement=agree)
    res["memory"] = lockstep_memory(torch, dev, net, work, slopes=False, dtype=torch.float32)
    res["mesh"] = mesh_lockstep(torch, dev, work, videos, dtype="float32")
    return res


def fast_encoder_off(torch, work: Path, n: int):
    """14f: ``SVOS_FAST_ENCODER=0`` under float32 on the strategies' clip:
    the module encodes (no bottleneck launch), and the masks agree with the
    fast encoder's on >= 99.9 % of pixels."""
    tree, ckpt = work / "strategies", work / "resnet50.pth.tar"
    runs = {}
    for fast in ("1", "0"):
        save = work / f"f32_fast_encoder_{fast}"
        with infer_dtype("float32", SVOS_FAST_ENCODER=fast):
            wall, launches = cli_run(torch, ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save)])
        runs[fast] = dict(save=save, seconds=wall, launches=launches)
    agree = png_agreement(runs["0"]["save"], runs["1"]["save"], {"clip": n}, "SVOS_FAST_ENCODER=0")
    log(f"14f SVOS_FAST_ENCODER=0 (float32): {runs['0']['seconds']:.3f} s, launches {runs['0']['launches']}; fast "
        f"encoder {runs['1']['seconds']:.3f} s; mask agreement {agree:.7f}")
    check(runs["0"]["launches"] == launch_counts(affinity_bank_f32=n - 1),
          "SVOS_FAST_ENCODER=0: no bottleneck launch, one float32 bank launch a frame")
    check(agree >= 0.999, "SVOS_FAST_ENCODER=0 masks agree with the fast encoder's on >= 99.9% of pixels")
    return dict(launches=runs["0"]["launches"], agreement=agree, seconds=runs["0"]["seconds"],
                fast_seconds=runs["1"]["seconds"])


def profiling_run(torch, work: Path):
    """14g: ``SVOS_PROFILE=1`` and ``SVOS_TRACE_DIR`` under float32 on the
    strategies' clip: the recorder's report is logged, the trace names both
    float32 kernels and holds the drain's spans, and the card's idle
    summary is logged."""
    import logging

    tree, trace_dir = work / "strategies", work / "trace"
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logging.getLogger("svos_torch").addHandler(handler)
    try:
        with infer_dtype("float32", SVOS_PROFILE="1", SVOS_TRACE_DIR=str(trace_dir)):
            wall, launches = cli_run(torch, ["inference", "-d", str(tree), "-r", str(work / "resnet50.pth.tar"),
                                             "-s", str(work / "f32_profiled")])
    finally:
        logging.getLogger("svos_torch").removeHandler(handler)
    report = [r for r in records if r.startswith("phase timing |")]
    idle = [r for r in records if r.startswith("device idle ")]
    traces = sorted(trace_dir.glob("*.json"))
    text = traces[0].read_text() if traces else ""
    kernels = {name: name in text for name in ("affinity_bank_f32_kernel", "bottleneck_f32_kernel")}
    log(f"14g SVOS_PROFILE / SVOS_TRACE_DIR: {wall:.3f} s; report {report}; {idle}; trace files "
        f"{[t.name for t in traces]} ({len(text) / 1e6:.1f} MB), kernels named {kernels}")
    check(len(report) == 1 and all(f"{name}: " in report[0] for name in (
        "engine.step", "engine.upload", "engine.encode", "engine.propagate", "engine.write", "drain.job",
        "upload.pageable_bytes")), "SVOS_PROFILE logs the recorder's spans and counters in one report")
    check(len(traces) == 1 and all(kernels.values()), "SVOS_TRACE_DIR writes one trace naming both float32 kernels")
    check('"svos.drain.job"' in text and len(idle) == 1,
          "the trace holds the drain's spans and the card's idle gaps are logged")
    return dict(report=report[0], idle=idle[0] if idle else None, trace_bytes=len(text), seconds=wall)


def tf32_wgmma_in_sass() -> dict:
    """Per float32 kernel, its library's warpgroup products by form, from
    ``cuobjdump -sass`` (3xTF32 shows as ``HGMMA.*.TF32``)."""
    import collections
    import re

    from semi_supervised_vos_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    out = {}
    for name in ("affinity_bank_f32", "bottleneck_f32"):
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        out[name] = dict(collections.Counter(re.findall(r"\bHGMMA\.\S+", sass)))
    return out


def float32_phase(torch, dev, rng, work: Path, net, videos: dict, lockstep_videos: dict, bf16: dict):
    """Phase 14: float32 inference on the card (``SVOS_INFER_DTYPE=float32``)."""
    frames, _ = load_video(work, "davis", "long", 1)
    sass = tf32_wgmma_in_sass()
    log(f"14 float32 kernels' warpgroup products (cuobjdump -sass): {sass}")
    check(all(any(form.endswith(".TF32") for form in forms) for forms in sass.values()),
          "both float32 kernels run tf32 wgmma (3xTF32)")
    res = {"sass_hgmma": sass, "bank": f32_bank_kernel(torch, dev, rng), "bottleneck": f32_bottleneck_kernel(torch, dev, rng)}
    res["encoder_min_cosine"] = {arch: f32_encoder(torch, dev, arch, frames[0]) for arch in ("resnet50", "facebook")}
    res["main_path"] = f32_main_path(torch, dev, work, net, videos, bf16)
    res["lockstep"] = f32_lockstep(torch, dev, work, net, lockstep_videos)
    res["fast_encoder_off"] = fast_encoder_off(torch, work, STRATEGY_FRAMES)
    res["profiling"] = profiling_run(torch, work)
    return res


# ---- phase 15: native host loaders, training over a mesh, the mesh CLIs --


def native_loaders(torch, work: Path, videos: dict):
    """15a: the native upsampler is on; the main path's PNGs with it off and
    on are byte-equal; the decoder's state (``SVOS_NATIVE_DECODE=1``) and,
    when it is on, the main path's frames byte-equal to PIL's; host ms of
    decoding the main path's frames (PIL, native) and of upsampling its
    masks (numpy, native)."""
    from io import BytesIO

    from PIL import Image

    from semi_supervised_vos_tpu_torch.data import native_decode
    from semi_supervised_vos_tpu_torch.ops import native_upsample
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    check(native_upsample.available(), f"the native upsampler is on ({native_upsample.reason or 'built, checked'})")
    tree, ckpt = work / "davis", work / "resnet50.pth.tar"
    runs = {}
    for flag in ("1", "0"):
        with infer_dtype("bfloat16", SVOS_NATIVE_UPSAMPLE=flag):
            native_upsample._state = None
            save = work / f"native_upsample_{flag}"
            wall, launches = cli_run(torch, ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save)])
            runs[flag] = dict(seconds=wall, launches=launches, engaged=native_upsample.available())
    native_upsample._state = None
    check(runs["1"]["engaged"] and not runs["0"]["engaged"], "SVOS_NATIVE_UPSAMPLE=1 engages the upsampler, =0 not")
    n_frames = sum(videos.values())
    pngs = [(v, f"{t:05d}.png") for v, n in videos.items() for t in range(n)]
    same = all((work / "native_upsample_1" / v / p).read_bytes() == (work / "native_upsample_0" / v / p).read_bytes()
               for v, p in pngs)
    log(f"15a main path with the native upsampler on: {runs['1']['seconds']:.3f} s, off: {runs['0']['seconds']:.3f} s "
        f"({n_frames} frames); launches on {runs['1']['launches']}")
    check(same and len(pngs) == n_frames, f"the main path's {n_frames} PNGs byte-equal with SVOS_NATIVE_UPSAMPLE=0 and 1")
    check(runs["1"]["launches"]["affinity_bank"] == n_frames - len(videos) and runs["1"]["launches"]["bottleneck"] > 0,
          "the main path under the native upsampler launches both kernels")

    blobs = [(tree / "JPEGImages" / "480p" / v / f"{t:05d}.jpg").read_bytes() for v, n in videos.items()
             for t in range(n)]
    pil_decode = lambda: [np.asarray(Image.open(BytesIO(b)).convert("RGB")) for b in blobs]  # noqa: E731
    pil = pil_decode()
    host = {"decode_pil_ms": _host_ms(pil_decode)}
    saved = os.environ.get("SVOS_NATIVE_DECODE")
    os.environ["SVOS_NATIVE_DECODE"] = "1"
    native_decode._state = None
    try:
        decoder_on = native_decode.available()
        if decoder_on:
            got = native_decode.decode_jpeg_batch(blobs)
            check(all(np.array_equal(g, p) for g, p in zip(got, pil)),
                  f"the native decoder's {len(blobs)} main-path frames byte-equal to PIL's")
            host["decode_native_ms"] = _host_ms(lambda: native_decode.decode_jpeg_batch(blobs))
            host["decode_native_one_thread_ms"] = _host_ms(lambda: [native_decode.decode_jpeg(b) for b in blobs])
    finally:
        native_decode._state = None
        if saved is None:
            os.environ.pop("SVOS_NATIVE_DECODE")
        else:
            os.environ["SVOS_NATIVE_DECODE"] = saved
    log(f"15a native JPEG decoder: {'on' if decoder_on else 'off: ' + native_decode.reason}")
    small = [nearest_resize_host(np.asarray(Image.open(work / "native_upsample_1" / v / p)), (60, 107))
             for v, p in pngs]
    small = np.stack(small)[:, None]  # (T, 1, 60, 107): the drain's layout
    want = native_upsample._numpy_twin(small, (H480, W480))
    check(np.array_equal(native_upsample.nearest_u8(small, (H480, W480)), want),
          "native upsampler byte-equal to numpy on the main path's masks")
    host["upsample_numpy_ms"] = _host_ms(lambda: native_upsample._numpy_twin(small, (H480, W480)))
    host["upsample_native_ms"] = _host_ms(lambda: native_upsample.nearest_u8(small, (H480, W480)))
    log(f"15a host ms over the main path's {len(blobs)} frames (median of 5, {os.cpu_count()} cores): "
        + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))
    return dict(upsampler="on", decoder="on" if decoder_on else "off", decoder_reason=native_decode.reason,
                frames=len(blobs), cores=os.cpu_count(), png_equal=same, launches=runs["1"]["launches"],
                cli_seconds_native=runs["1"]["seconds"], cli_seconds_numpy=runs["0"]["seconds"], **host)


def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


MESH_TRAIN_SHAPES = {"dp 4": (4, 1), "data 2 x model 2": (2, 2)}
MESH_LOSS_RTOL = 1e-4
MESH_MIN_COS = 0.999
MESH_TRAIN_REPS = 3


def mesh_training(torch, dev, work: Path):
    """15b: the mesh train step at full width (resnet50, bs 16 x 10 frames x
    256^2) on virtual meshes naming the card, each beside the single-device
    step from the same weights and batch, TF32 off: loss, the conv1
    update's cosine, the largest BN running-statistic difference, device ms
    a step, peak memory."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.parallel.tp import shard_tp
    from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet, make_mesh_train_step
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, iterate_batches, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    tree = work / "train"
    ds = TrainDataset(tree / "JPEGImages" / "480p", tree / "Annotations" / "480p", cropping=TRAIN_CROP,
                      frame_num=TRAIN_FRAMES)
    imgs, anns = next(iterate_batches(ds, TRAIN_BS, num_workers=8))
    imgs, anns = torch.as_tensor(imgs, device=dev), torch.as_tensor(anns, device=dev)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    total = torch.cuda.get_device_properties(0).total_memory
    spec = LossSpec(name="cross_entropy")
    net = build_train_net("resnet50", dev).train()
    start = {k: v.clone() for k, v in net.state_dict().items()}

    def make(shape):
        net.load_state_dict(start)
        optimizer = make_optimizer(net.parameters())
        if shape is None:
            step = make_train_step(net, spec, optimizer)
        else:
            mesh = virtual_mesh(torch, dev, *shape)
            mnet = shard_tp(mesh, net, optimizer) if shape[1] > 1 else MeshNet(mesh, net, optimizer)
            step = make_mesh_train_step(mnet, spec)
        generator = torch.Generator(device=dev).manual_seed(42)
        return (lambda: step(imgs, anns, centroids, generator)), (mnet.sync_to_net if shape is not None else None)

    def one(shape):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, sync = make(shape)
        loss = step().item()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if sync is not None:
            sync()
        state = {k: v.clone() for k, v in net.state_dict().items()}
        t = time_ms(step, reps=MESH_TRAIN_REPS, warmup=1)
        return loss, state, peak, t

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    loss1, state1, peak1, t1 = one(None)
    u1 = (state1["backbone.0.weight"] - start["backbone.0.weight"]).flatten().double()
    stat_keys = [k for k in start if k.endswith(("running_mean", "running_var"))]
    out = {"single": dict(loss=loss1, **timing_keys("ms", t1), peak_share=peak1 / total)}
    log(f"15b single step, resnet50 bs {TRAIN_BS} x {TRAIN_FRAMES} x {TRAIN_CROP}^2, TF32 off: loss {loss1:.7f}, "
        f"{t1:.3f} ms, peak {peak1 / total:.4f} of the card")
    for name, shape in MESH_TRAIN_SHAPES.items():
        loss, state, peak, t = one(shape)
        u = (state["backbone.0.weight"] - start["backbone.0.weight"]).flatten().double()
        cos = float(u @ u1 / (u.norm() * u1.norm()))
        rel = abs(loss - loss1) / abs(loss1)
        bn = max(float((state[k] - state1[k]).abs().max()) for k in stat_keys)
        clips = TRAIN_BS // shape[0]
        out[name] = dict(mesh=list(shape), clips_per_row=clips, loss=loss, loss_rel=rel, conv1_update_cos=cos,
                         bn_stat_max_abs=bn, **timing_keys("ms", t), ms_over_single=float(t) / float(t1),
                         peak_share=peak / total)
        log(f"15b {name} ({clips} clips a row) on a mesh naming the card {shape[0] * shape[1]} times: loss "
            f"{loss:.7f} (relative {rel:.2e}), conv1 update cosine {cos:.7f}, BN running statistics max "
            f"difference {bn:.2e}, {t:.3f} ms a step ({float(t) / float(t1):.3f}x the single step), peak "
            f"{peak / total:.4f} of the card")
        check(rel <= MESH_LOSS_RTOL, f"{name}: loss within {MESH_LOSS_RTOL} of the single step's")
        check(cos >= MESH_MIN_COS, f"{name}: conv1 update cosine >= {MESH_MIN_COS}")
        check(peak / total < 0.85, f"{name}: peak below 0.85 of the card")
    del net
    torch.cuda.empty_cache()
    return out


def mesh_cli_and_dryrun(torch, dev, work: Path):
    """15c: ``train_command_impl(devices=[card] * 2, tp=2)`` for 2 epochs on
    phase 11's tree, ``validation_command_impl(devices=[card] * 2)`` on its
    checkpoints, and ``dryrun_multichip([card] * 4)``, each with its kernel
    launches."""
    from semi_supervised_vos_tpu_torch.cli.train import train_command_impl
    from semi_supervised_vos_tpu_torch.cli.validation import validation_command_impl
    from semi_supervised_vos_tpu_torch.parallel.dryrun import dryrun_multichip

    tree, ckpts = work / "train", work / "train_tp2"
    reset_kernel_launches()
    t0 = time.perf_counter()
    train_command_impl(frame_num=TRAIN_FRAMES, training=str(tree), validation=str(tree), resume=None,
                       save_model=str(ckpts), epochs=2, bs=TRAIN_BS, lr=0.02, loss="cross_entropy", freeze=False,
                       miner="default", margin=0.1, loss_weight=1.0, max_triplets=0, early_stop=False,
                       model_name="resnet50", device="cuda", disable=True, tp=2, devices=[dev] * 2)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = kernel_launches()
    names = sorted(p.name for p in ckpts.iterdir())
    losses = [float(n.split("-")[3]) for n in names]
    clips = 2 * (sum(TRAIN_VIDEOS.values()) // TRAIN_BS) * TRAIN_BS
    log(f"15c train --tp 2 on [card] x 2: {clips} clips in {train_wall:.3f} s = {clips / train_wall:.3f} clips/s; "
        f"checkpoints {names}; launches {train_launches}")
    check(len(names) == 2 and all(math.isfinite(v) for v in losses), "two checkpoints with finite losses")
    reset_kernel_launches()
    t0 = time.perf_counter()
    val = validation_command_impl(str(tree), str(ckpts), TRAIN_BS, "cross_entropy", "default", 0.1, 6.0, None,
                                  model_name="resnet50", device="cuda", disable=True, frame_num=TRAIN_FRAMES,
                                  devices=[dev] * 2)
    val_wall = time.perf_counter() - t0
    val_launches = kernel_launches()
    val_in_name = float(names[0].split("-")[4][: -len(".pth.tar")])
    log(f"15c validation on [card] x 2: {val} in {val_wall:.3f} s; launches {val_launches}")
    check(sorted(val) == names and all(math.isfinite(v) for v in val.values()), "validation: a finite loss a checkpoint")
    check(abs(val[names[0]] - val_in_name) <= 1e-3 * abs(val_in_name),
          "validation on epoch 0's --tp 2 checkpoint reproduces the train CLI's epoch-0 validation loss to 1e-3")
    reset_kernel_launches()
    t0 = time.perf_counter()
    dry = dryrun_multichip([dev] * 4)
    torch.cuda.synchronize()
    dry_wall = time.perf_counter() - t0
    dry_launches = kernel_launches()
    log(f"15c dryrun_multichip([card] x 4) in {dry_wall:.3f} s: {dry}; launches {dry_launches}")
    check(dry_launches["affinity_bank"] > 0 and dry_launches["bottleneck"] > 0,
          "the dry run's sharded engines launch the bank kernel (stats mode) and the bottleneck")
    return dict(train=dict(seconds=train_wall, clips_per_s=clips / train_wall, losses=losses,
                           launches=train_launches),
                validation=dict(seconds=val_wall, losses=val, launches=val_launches),
                dryrun=dict(seconds=dry_wall, launches=dry_launches, **dry))


def native_and_mesh_phase(torch, dev, work: Path, videos: dict):
    """Phase 15: the native host loaders, training over a mesh, the mesh CLIs
    and the dry run."""
    return {"native": native_loaders(torch, work, videos), "mesh_training": mesh_training(torch, dev, work),
            "cli": mesh_cli_and_dryrun(torch, dev, work)}


# ---- phase 16: wide float32 frames, the last public names ------------------

WIDE_HW = (2, 960)  # the feature grid of 16 x 7680 frames: 8K video's width
WIDE_CLIP = (32, 7680, 8)  # h, w, frames of the wide float32 CLI run (feature grid 4 x 960)


def f32_wide_bank(torch, dev, rng, ms_14a: float):
    """16a: the float32 bank kernel against its plain version on frames of
    any width (K 9, C 256): hd 2 x wd 960 at B = 1 and 2 (the column table
    clamped at the prior's zero), with sigma_2 100 (a prior too wide for the
    table: the factor per pair), a ragged 3 x 997 grid, and two stats shards
    (the second at row_base 960) combined against the plain version; then
    14a's 480p B = 1 case again beside 14a's time in this run, and
    B = 8 in probability mode in turns with float32
    ``scaled_dot_product_attention`` at batch 8."""
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
    from semi_supervised_vos_tpu_torch.ops import affinity as aff
    from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine

    c, d, d_pad, cap, k = 256, 22, 24, 45, 9
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    make = functools.partial(f32_bank_inputs, torch, gen)
    compare = lambda name, got, expect, gate=AFFINITY_GATE: f32_bank_compare(  # noqa: E731
        f"16a float32 bank kernel {name}", got, expect, gate)

    before = (aff.affinity_from_bank_batched.launches, aff.affinity_from_bank_batched.launches_f32)
    worst = 0.0
    calls = 0
    for name, (hd, wd), b, sigma_2 in (("2x960 B=1", WIDE_HW, 1, 21.0), ("2x960 B=2", WIDE_HW, 2, 21.0),
                                       ("2x960 B=1 sigma_2 100", WIDE_HW, 1, 100.0),
                                       ("3x997 ragged P", (3, 997), 1, 21.0)):
        fe, la, ta = make(b, hd * wd)
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, sigma_2=sigma_2)
        worst = max(worst, compare(name, aff.affinity_from_bank_batched(fe, la, ta, slots, **kw),
                                   aff.affinity_from_bank_plain(fe, la, ta, slots, **kw)))
        calls += 1
    hd, wd = WIDE_HW
    p = hd * wd
    feats, labels, tgt = make(1, p)
    kw = dict(feature_hw=WIDE_HW, temperature=1.0, valid=valid, dense=dense)
    half = p // 2
    stats = [aff.affinity_from_bank_batched(feats[:, :, s : s + half].contiguous(),
                                            labels[:, :, s : s + half].contiguous(), tgt, slots, row_base=s,
                                            return_stats=True, **kw) for s in (0, half)]
    calls += 2
    stats_err = compare(f"2x960 two stats shards (row_base 0, {half}) + combine vs the plain version",
                        distributed_softmax_combine(*zip(*stats)), aff.affinity_from_bank_plain(
                            feats, labels, tgt, slots, **kw), STATS_GATE)
    check((aff.affinity_from_bank_batched.launches, aff.affinity_from_bank_batched.launches_f32)
          == (before[0], before[1] + calls), f"wide float32 banks: {calls} float32 bank launches, no bf16 one")
    wide_ms = time_ms(lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw))

    # 14a's 480p case again, and B = 8 in probability mode beside float32
    # attention over the valid slots' rows at batch 8
    hd, wd = out_spatial(H480, W480)
    p = hd * wd
    feats8, labels8, tgt8 = make(8, p)
    feats, labels, tgt = feats8[:, :1].contiguous(), labels8[:, :1].contiguous(), tgt8[:1].contiguous()
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    ms = time_ms(lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw))
    sel = torch.as_tensor(slots[valid], device=dev)
    q = tgt8[:, None]
    keys = feats8[sel].permute(1, 0, 2, 3).reshape(8, 1, -1, c)
    values = labels8[sel].float().permute(1, 0, 2, 3).reshape(8, 1, -1, d_pad)
    run_prob = lambda: aff.affinity_from_bank_batched(feats8, labels8, tgt8, slots, spatial=False, **kw)  # noqa: E731
    run_library = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)  # noqa: E731
    sdpa_err = (run_library()[:, 0, :, :d].transpose(1, 2) - run_prob()[:, :d]).abs().max().item()
    check(sdpa_err <= SDPA_GATE, f"float32 scaled_dot_product_attention at batch 8 agrees with the kernel <= {SDPA_GATE}")
    turns = [time_ms(run_prob, reps=10), time_ms(run_library, reps=10), time_ms(run_library, reps=10),
             time_ms(run_prob, reps=10)]
    prob_ms, library_ms = min(turns[0], turns[3], key=float), min(turns[1], turns[2], key=float)
    nbytes = k * p * (c * 4 + d_pad * 2) + p * c * 4 + d_pad * p * 4
    prob_b_ms, prob_b_by = affinity_bound(dev, k, p, wd, c, d, np.zeros(k), nbytes, PEAK_TF32_FLOPS,
                                          products=3)
    log(f"16a float32 bank kernel: 2x960 B=1 {wide_ms:.4f} ms; 480p B=1 {ms:.4f} ms (14a {ms_14a:.4f} ms in this run); "
        f"480p B=8 probability mode {turns[0]:.4f} / {turns[3]:.4f} ms, float32 "
        f"scaled_dot_product_attention at batch 8 {turns[1]:.4f} / {turns[2]:.4f} ms (max_abs {sdpa_err:.3e}), bound "
        f"{8 * prob_b_ms:.4f} ms ({prob_b_by}); kernel / library {prob_ms / library_ms:.3f}")
    del feats8, labels8, tgt8, keys, values
    return dict(max_abs_err=worst, stats_max_abs_err=stats_err, wide_ms=wide_ms, ms_480p=ms, ms_480p_14a=ms_14a,
                b8_prob_ms=prob_ms, b8_prob_bound_ms=8 * prob_b_ms,
                b8_prob_library_ms=library_ms)


def f32_wide_cli(torch, work: Path):
    """16b: ``inference`` under ``SVOS_INFER_DTYPE=float32`` through the CLI
    on a tree of one WIDE_CLIP video (feature grid 4 x 960) with phase 7's
    resnet50 checkpoint: one float32 bank launch a propagated frame and 11
    float32 bottleneck launches an encode call, none of the bf16 kernels;
    its masks against ``inference --device cpu`` (float32) on >= 99.5 % of
    pixels (phase 14's bar)."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len

    h, w, n = WIDE_CLIP
    tree, ckpt = work / "wide", work / "resnet50.pth.tar"
    make_davis_tree(tree, {"wide": n}, (h, w), seed=5)
    runs = {}
    with infer_dtype("float32"):
        for device in ("cuda", "cpu"):
            save = work / f"wide_f32_{device}"
            runs[device] = (save, *cli_run(torch, ["inference", "-d", str(tree), "-r", str(ckpt), "-s", str(save),
                                                   "--device", device]))
    (save, wall, launches), (cpu_save, cpu_wall, _) = runs["cuda"], runs["cpu"]
    agree = png_agreement(save, cpu_save, {"wide": n}, "wide float32 card vs CPU")
    classes = sorted(set().union(*(np.unique(np.asarray(Image.open(save / "wide" / f"{t:05d}.png"))).tolist()
                                   for t in range(1, n))))
    encodes = 1 + math.ceil((n - 1) / chunk_len())
    log(f"16b float32 inference {h}x{w} (feature grid 4 x {w // 8}), {n} frames: card {wall:.3f} s, launches "
        f"{launches}, mask classes {classes}; CPU {cpu_wall:.3f} s; card vs CPU masks {agree:.6f}")
    check(launches == launch_counts(affinity_bank_f32=n - 1, bottleneck_f32=11 * encodes),
          f"wide float32 inference: {n - 1} float32 bank and {11 * encodes} float32 bottleneck launches, none of the "
          "bf16 kernels")
    check(agree >= 0.995, "wide float32 card masks agree with the CPU's on >= 99.5% of pixels")
    return dict(frames=n, size=[h, w], seconds=wall, cpu_seconds=cpu_wall, launches=launches, agreement=agree,
                classes=classes)


def entry_and_stack(torch, dev, rng, net):
    """16c: the port's flagship step (``graft_entry.py::entry``, on the card
    by default) against the same step on the CPU: argmax agreement >= 98 %
    (phase 7's card-vs-CPU bar), one ``affinity_propagate_fused`` launch a
    step and no other kernel; then ``bottleneck_stack`` over the 5 stride-1
    blocks of resnet50's layer3, folded from ``net``, at N = 8 and 480p
    against the plain stack: bf16 at the bottleneck gate (cosine >= 0.9999,
    max error <= 2e-2 of the largest output) and float32 with the fold-time
    planes (<= 1e-4), one launch a block."""
    import copy

    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.graft_entry import entry
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block_plain, bottleneck_stack

    step, args = entry()
    check(all(a.device.type == "cuda" for a in args[1:4]), "entry() puts the step's inputs on the card by default")
    reset_kernel_launches()
    mask = step(*args)
    torch.cuda.synchronize()
    launches = kernel_launches()
    cpu_args = (copy.deepcopy(args[0]).cpu(), *(a.cpu() for a in args[1:4]), args[4])
    agree = (mask.cpu() == step(*cpu_args)).double().mean().item()
    step_ms = time_ms(lambda: step(*args))
    log(f"16c entry step on the card: mask {tuple(mask.shape)}, launches {launches}, argmax agreement with the CPU "
        f"step {agree:.6f}, {step_ms:.4f} ms a step")
    check(launches == launch_counts(affinity_propagate=1), "the entry step: one affinity_propagate_fused launch, "
          "no other kernel")
    check(agree >= 0.98, "the entry step's argmax agrees with the CPU step's on >= 98% of pixels")

    hd, wd = out_spatial(H480, W480)
    blocks = [f"layer3_{b}" for b in range(1, 6)]
    x = torch.relu(torch.as_tensor(rng.standard_normal((8, hd, wd, 1024)), dtype=torch.float32, device=dev))
    res = dict(entry=dict(launches=launches, agreement=agree, ms=step_ms), stack={})
    for dtype in (torch.bfloat16, torch.float32):
        table = fold_vosnet(net.to(dev), dtype)
        wts = [table[f"{b}/fused"] for b in blocks]
        planes = [table[f"{b}/fused_tf32"] for b in blocks] if dtype == torch.float32 else None
        xd = x.to(dtype)
        reset_kernel_launches()
        got = bottleneck_stack(xd, wts, planes=planes).float()
        torch.cuda.synchronize()
        stack_launches = kernel_launches()
        expect = xd
        for blk in wts:
            expect = bottleneck_block_plain(expect, *blk)
        expect = expect.float()
        rel = ((got - expect).abs().max() / expect.abs().max()).item()
        # in float64: a float32 cosine of 50 M values is off by ~1e-5 by itself
        cos = F.cosine_similarity(got.double().flatten(), expect.double().flatten(), dim=0).item()
        ms = time_ms(lambda: bottleneck_stack(xd, wts, planes=planes), reps=10)
        name = "bf16" if dtype == torch.bfloat16 else "float32"
        log(f"16c bottleneck_stack {name}, resnet50 layer3 blocks 1-5, N=8 at 480p: max_abs/max_ref={rel:.3e} "
            f"cos={cos:.7f}, launches {stack_launches}, {ms:.4f} ms")
        key = "bottleneck" if dtype == torch.bfloat16 else "bottleneck_f32"
        check(stack_launches == launch_counts(**{key: len(blocks)}), f"bottleneck_stack {name}: one {key} launch a "
              "block, no other kernel")
        if dtype == torch.bfloat16:
            check(cos >= 0.9999 and rel <= 2e-2, "bottleneck_stack bf16: cos >= 0.9999, rel <= 2e-2")
        else:
            check(rel <= 1e-4, "bottleneck_stack float32: max error <= 1e-4 of the largest output")
        res["stack"][name] = dict(launches=stack_launches, max_rel_err=rel, cos=cos, ms=ms)
    return res


def wide_and_surface_phase(torch, dev, rng, work: Path, net, f32: dict):
    """Phase 16: the float32 bank kernel on wide frames and the wide float32
    CLI run, the flagship step and ``bottleneck_stack``."""
    return {"bank": f32_wide_bank(torch, dev, rng, f32["bank"]["ms"]), "cli": f32_wide_cli(torch, work),
            "entry_and_stack": entry_and_stack(torch, dev, rng, net)}


# ---- phase 17: the benches ------------------------------------------------


BENCH_ENV = {"SVOS_BENCH_PASSES": "1", "SVOS_BENCH_STRATEGIES": "0", "SVOS_BENCH_FULL": "0"}
BENCH_TRAIN_ENV = {"SVOS_BENCH_PASSES": "1"}


def bench_line(module: str, env: dict) -> dict:
    """Run ``python -m semi_supervised_vos_tpu_torch.<module>`` on the card
    with ``env`` added; its last stdout line, parsed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"semi_supervised_vos_tpu_torch.{module}"], cwd=ROOT,
                          env={**os.environ, **env}, capture_output=True, text=True, timeout=900)
    for line in proc.stderr.strip().splitlines()[-12:]:
        log(f"  {module}: {line}")
    check(proc.returncode == 0, f"{module} exits 0 (in {time.perf_counter() - t0:.1f} s)")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def bench_phase(torch) -> dict:
    """Phase 17: both benches at a reduced protocol, their checks held to
    the kernel gates."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the benches' processes need the card's memory
    inf = bench_line("bench", BENCH_ENV)
    kc, sc = inf["kernel_check"], inf["sharded_kernel_check"]
    log(f"bench: value {inf['value']:.3f} frames/s, mfu {inf['mfu']:.6f} at {inf['gflop_per_frame']:.3f} GFLOP a "
        f"frame, phase_ms {inf['phase_ms']}, kernel_check {kc}, sharded_kernel_check {sc}")
    check(max(kc["max_abs_diff"], kc["batched_max_abs_diff"]) <= AFFINITY_GATE
          and kc["argmax_agreement"] == kc["batched_argmax_agreement"] == 1.0,
          f"bench kernel check <= {AFFINITY_GATE} / 1.0")
    check(sc["stats_max_abs_diff"] <= STATS_GATE and sc["stats_argmax_agreement"] == 1.0,
          f"bench stats shards <= {STATS_GATE} / 1.0")
    check(kc["encoder_min_cos"] >= ENCODER_MIN_COS, f"bench encoder min cosine >= {ENCODER_MIN_COS}")
    check(sc["engine_mask_agreement"] == sc["batched_engine_mask_agreement"] == 1.0,
          "bench sharded engines' masks equal the plain engines'")
    check(0.0 < inf["mfu"] <= 1.0 and inf["value"] > 0.0, "bench mfu in (0, 1]")
    check(all(v is not None and math.isfinite(v) for v in inf["phase_ms"].values()), "bench phase_ms measured")
    check(inf["launches"]["affinity_bank"] > 0 and inf["launches"]["bottleneck"] > 0,
          f"bench launched both kernels ({inf['launches']})")
    train = bench_line("bench_train", BENCH_TRAIN_ENV)
    log(f"bench_train: {train['value']:.4f} steps/s, {train['step_tflop']:.4f} TFLOP a step, mfu {train['mfu']:.6f}")
    check(0.0 < train["mfu"] <= 1.0, "bench_train mfu in (0, 1]")
    return {"bench": inf, "bench_train": train}


def main() -> int:
    if not (PACKAGE / "__init__.py").is_file():
        log("FAILED: the semi_supervised_vos_tpu_torch package is not beside this script")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("FAILED: no CUDA device")
        return 1
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
            if any(key in line for key in ("Compiling entry", "registers", "spill", "smem", "Performance Loss")):
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
        card_vs_cpu = small_clip_parity(torch, dev, net, work)
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
        stage("phase 13: multi-device inference on a virtual one-card mesh")
        mesh = mesh_phase(torch, dev, rng, work, net, videos, lockstep_videos)
        stage("phase 14: float32 inference (SVOS_INFER_DTYPE=float32)")
        bf16 = dict(fps=fps, engine_ms=engine_ms, card_vs_cpu=card_vs_cpu)
        f32 = float32_phase(torch, dev, rng, work, net, videos, lockstep_videos, bf16)
        stage("phase 15: native host loaders, training over a mesh, the mesh CLIs and the dry run")
        p15 = native_and_mesh_phase(torch, dev, work, videos)
        stage("phase 16: wide float32 frames, the flagship step, bottleneck_stack")
        p16 = wide_and_surface_phase(torch, dev, rng, work, net, f32)
    stage("phase 17: the benches (python -m semi_supervised_vos_tpu_torch.bench, .bench_train)")
    p17 = bench_phase(torch)
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

    me = mesh["engine"]
    log(f"multi-device on {card} (virtual one-card mesh): {me['shards']}-shard engine {me['sharded_ms_per_frame']:.4f} "
        f"ms/frame against the single engine's {me['single_ms_per_frame']:.4f}, mask agreement {me['agreement']:.7f}; "
        f"dp 2 x bank 2 lockstep agreement {mesh['lockstep']['agreement']:.7f}; CLI: {mesh['cli']['case']}")

    f32m, f32l = f32["main_path"], f32["lockstep"]
    log(f"float32 on {card}: main path {f32m['fps']:.3f} fps end to end (bf16 {fps:.3f}), engine "
        f"{f32m['engine_ms_per_frame']:.4f} ms/frame (bf16 {engine_ms:.4f}), card vs CPU masks "
        f"{f32m['card_vs_cpu_agreement']:.6f} (bf16 {card_vs_cpu:.6f}); --video-batch 8 {f32l['fps_vb8']:.3f} fps; "
        f"bank kernel {f32['bank']['ms']:.4f} ms at 480p (bf16 {aff['ms']:.4f}), bottleneck {f32['bottleneck']['ms']:.4f} "
        f"ms per 8-frame encode call (bf16 {bott['ms']:.4f})")

    nat, mt, mc = p15["native"], p15["mesh_training"], p15["cli"]
    log(f"native loaders on {card}: upsampler on, PNGs byte-equal off and on; decoder {nat['decoder']}"
        + (f" ({nat['decoder_reason']})" if nat["decoder"] == "off" else "")
        + f"; host ms over {nat['frames']} frames: " + ", ".join(f"{k} {nat[k]:.3f}" for k in nat if k.endswith("_ms")))
    log(f"mesh training on {card} (virtual one-card mesh, resnet50 bs {TRAIN_BS} x {TRAIN_FRAMES} x {TRAIN_CROP}^2, "
        f"TF32 off): single {mt['single']['ms']:.3f} ms, peak {mt['single']['peak_share']:.4f}; "
        + "; ".join(f"{k} {mt[k]['ms']:.3f} ms ({mt[k]['ms_over_single']:.3f}x), loss relative {mt[k]['loss_rel']:.2e}, "
                    f"cosine {mt[k]['conv1_update_cos']:.7f}, peak {mt[k]['peak_share']:.4f}" for k in MESH_TRAIN_SHAPES)
        + f"; train --tp 2 {mc['train']['clips_per_s']:.3f} clips/s; dryrun_multichip in {mc['dryrun']['seconds']:.3f} s")
    wb, wc, es = p16["bank"], p16["cli"], p16["entry_and_stack"]
    log(f"wide float32 on {card}: bank kernel {wb['wide_ms']:.4f} ms at hd {WIDE_HW[0]} x wd {WIDE_HW[1]} (480p "
        f"{wb['ms_480p']:.4f} ms; 14a {wb['ms_480p_14a']:.4f}), B=8 probability mode "
        f"{wb['b8_prob_ms']:.4f} ms against float32 scaled_dot_product_attention {wb['b8_prob_library_ms']:.4f} ms; "
        f"{wc['size'][0]}x{wc['size'][1]} CLI {wc['frames'] / wc['seconds']:.3f} fps, card vs CPU masks "
        f"{wc['agreement']:.6f}; entry step {es['entry']['ms']:.4f} ms, agreement {es['entry']['agreement']:.6f}; "
        "bottleneck_stack " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in es["stack"].items()))

    b, bt = p17["bench"], p17["bench_train"]
    log(f"benches on {card} (reduced protocol): bench {b['value']:.3f} frames/s batched (B = 8), mfu {b['mfu']:.6f}; "
        f"bench_train {bt['value']:.4f} steps/s, mfu {bt['mfu']:.6f}")

    # launches: the main path's (kernel 3: its own path's; the float32
    # variants: phase 14d's); launches_by_path: each strategy's run; prob_*:
    # probability mode at 480p, where scaled_dot_product_attention computes
    # the same function
    keys = ("affinity_bank", "bottleneck", "affinity_bank_f32", "bottleneck_f32")
    by_path = {k: {name: r["launches"][k] for name, r in strategies.items()} for k in keys}
    for k in by_path:
        by_path[k]["lockstep single --video-batch 8"] = lc["launches_vb8"][k]
        for name, r in lockstep["strategies"].items():
            by_path[k][f"lockstep {name} --video-batch 2"] = r["launches"][k]
        by_path[k]["facebook single"] = fb["launches"][k]
        by_path[k]["multimodel resnet50 + facebook"] = facebook["multimodel"]["launches"][k]
        by_path[k]["sharded engine, 4 bank shards (virtual mesh)"] = mesh["engine"]["launches"][k]
        by_path[k]["lockstep dp 2 x bank 2 --video-batch 3 (virtual mesh)"] = mesh["lockstep"]["launches"][k]
        by_path[k]["float32 single"] = f32m["launches"][k]
        by_path[k]["float32 lockstep single --video-batch 8"] = f32l["launches_vb8"][k]
        by_path[k]["float32 lockstep dp 2 x bank 2 --video-batch 3 (virtual mesh)"] = f32l["mesh"]["launches"][k]
        by_path[k]["float32 SVOS_FAST_ENCODER=0"] = f32["fast_encoder_off"]["launches"][k]
        by_path[k]["main path under the native upsampler"] = nat["launches"][k]
        by_path[k]["train --tp 2 and validation on [card] x 2"] = mc["train"]["launches"][k] + \
            mc["validation"]["launches"][k]
        by_path[k]["dryrun_multichip([card] x 4)"] = mc["dryrun"]["launches"][k]
        by_path[k][f"float32 single {wc['size'][0]}x{wc['size'][1]}"] = wc["launches"][k]
        by_path[k]["entry step"] = es["entry"]["launches"][k]
        by_path[k]["bottleneck_stack layer3 bf16 + float32"] = sum(r["launches"][k] for r in es["stack"].values())
    lk = lockstep["kernels"]
    prob_keys = dict(prob_bound_ms=prob["bound_ms"], prob_bound_by=prob["bound_by"], prob_library_ms=prob["library_ms"])
    kernels = [
        dict(name="affinity_bank", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/affinity_bank.cu",
             replaces="semi_supervised_vos_tpu/ops/affinity_pallas.py:355", launches=launches["affinity_bank"], **aff,
             prob_ms=prob["bank_ms"], **prob_keys, launches_by_path=by_path["affinity_bank"],
             stats_shards=mesh["kernels"],
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
             launches_by_path={"entry step": es["entry"]["launches"]["affinity_propagate"]},
             launches_training=training["cli"]["launches"]["affinity_propagate"]),
        dict(name="affinity_bank_f32", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/affinity_bank_f32.cu",
             replaces="semi_supervised_vos_tpu/ops/affinity_pallas.py:355", launches=f32m["launches"]["affinity_bank_f32"],
             **f32["bank"], launches_by_path=by_path["affinity_bank_f32"],
             wide_ms=wb["wide_ms"], wide_max_abs_err=wb["max_abs_err"], wide_stats_max_abs_err=wb["stats_max_abs_err"],
             ms_480p_16a=wb["ms_480p"], b8_prob_ms=wb["b8_prob_ms"], b8_prob_bound_ms=wb["b8_prob_bound_ms"],
             b8_prob_library_ms=wb["b8_prob_library_ms"],
             launches_training=training["cli"]["launches"]["affinity_bank_f32"]),
        dict(name="bottleneck_f32", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/bottleneck_f32.cu",
             replaces="semi_supervised_vos_tpu/ops/bottleneck_pallas.py:121", launches=f32m["launches"]["bottleneck_f32"],
             **f32["bottleneck"], launches_by_path=by_path["bottleneck_f32"],
             launches_training=training["cli"]["launches"]["bottleneck_f32"]),
    ]
    print(json.dumps({"strategies": {name: dict(fps=r["fps"], seconds=r["seconds"], jf=r["jf"])
                                     for name, r in strategies.items()}}))
    print(json.dumps({"lockstep": lockstep}))
    print(json.dumps({"training": training}))
    print(json.dumps({"facebook": facebook}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"float32": f32}))
    print(json.dumps({"native_and_mesh": p15}))
    print(json.dumps({"wide_and_surface": p16}))
    print(json.dumps({"benches": p17}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
