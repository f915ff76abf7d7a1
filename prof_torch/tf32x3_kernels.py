"""The two float32 kernels (3xTF32 on wgmma) alone: build, check, time.

    python3 prof_torch/tf32x3_kernels.py

Builds ``csrc/affinity_bank_f32.cu`` and ``csrc/bottleneck_f32.cu`` (and
``csrc/affinity_bank.cu``, whose combine kernel the bank sweep uses) with
``nvcc``, prints each one's ``ptxas`` registers, spills and warnings (a
serialised wgmma pipeline shows there) and its warpgroup products from
``cuobjdump -sass``, then holds each kernel against its plain version
(float32, TF32 off) at the main path's shapes and the edge cases of
``chip_smoke.py`` phase 14a / 14b, and times kernel and library call in
turns (kernel, library, library, kernel) beside the plain version and the
3xTF32 and FFMA bounds. Prints one line per case and a JSON line last.
Needs one NVIDIA Hopper card; a quicker loop than ``chip_smoke.py`` for
work on these two kernels (about 30 s of command).
"""

from __future__ import annotations

import json
import math
import re
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def ptxas_lines(name: str) -> list:
    """The compiler's register, spill and shared-memory lines and any
    warning (a serialised wgmma pipeline shows here)."""
    from semi_supervised_vos_tpu_torch.ops._build import build_log

    return [ln.strip() for ln in build_log(name).splitlines()
            if re.search(r"registers|spill|smem|warning|wgmma|Potential", ln)]


def bank_cases(torch, cs, dev, rng) -> dict:
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.ops import affinity as aff

    c, cap, k = 256, 45, 9
    idx, valid, dense = sample_frames(50, 40, k)
    slots = idx % cap
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))

    def make(b, p, d_pad, d):
        feats = torch.randn((cap, b, p, c), generator=gen, device=dev) * 0.2
        labels = F.one_hot(torch.randint(0, d, (cap, b, p), generator=gen, device=dev), d_pad).to(torch.bfloat16)
        return feats, labels, torch.randn((b, p, c), generator=gen, device=dev) * 0.2

    worst = 0.0
    out = {}
    cases = [("480p B=1 prior", (60, 107), 1, 24, 22, True, 0, False),
             ("480p B=1 probability", (60, 107), 1, 24, 22, False, 0, False),
             ("480p B=2", (60, 107), 2, 24, 22, True, 0, False),
             ("13x27 ragged", (13, 27), 1, 24, 22, True, 0, False),
             ("dw 8", (16, 20), 1, 8, 6, True, 0, False),
             ("dw 16", (16, 20), 1, 16, 13, True, 0, False),
             ("d_pad 48 (two sweeps)", (16, 20), 1, 48, 40, True, 0, False),
             ("row_base shard", (60, 107), 1, 24, 22, True, 3200, True)]
    for name, (hd, wd), b, d_pad, d, spatial, row_base, stats in cases:
        p = hd * wd
        feats, labels, tgt = make(b, p - row_base, d_pad, d)
        if row_base:
            tgt = torch.randn((b, p, c), generator=gen, device=dev) * 0.2
        kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense, spatial=spatial,
                  row_base=row_base, return_stats=stats)
        got = aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)
        expect = aff.affinity_from_bank_plain(feats, labels, tgt, slots, **kw)
        if stats:  # m, l, acc: relative to each one's largest value
            max_abs = max(((g - e).abs().max() / e.abs().max()).item() for g, e in zip(got, expect))
            agree = 1.0
        else:
            max_abs = (got[:, :d] - expect[:, :d]).abs().max().item()
            agree = (got[:, :d].argmax(1) == expect[:, :d].argmax(1)).double().mean().item()
        worst = max(worst, max_abs)
        cs.log(f"bank {name}: max_abs={max_abs:.3e} argmax_agreement={agree}")
        out[name] = dict(max_abs=max_abs, agree=agree)
    feats, labels, tgt = make(1, 6420, 24, 22)
    kw = dict(feature_hw=(60, 107), temperature=1.0, valid=valid, dense=dense)
    run = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, **kw)  # noqa: E731
    run_prob = lambda: aff.affinity_from_bank_batched(feats, labels, tgt, slots, spatial=False, **kw)  # noqa: E731
    sel = torch.as_tensor(slots[valid], device=dev)
    q, keys = tgt[:, None], feats[sel, 0].reshape(1, 1, -1, c)
    values = labels[sel, 0].float().reshape(1, 1, -1, 24)
    lib = lambda: F.scaled_dot_product_attention(q, keys, values, scale=1.0)  # noqa: E731
    t = [cs.time_ms(run), cs.time_ms(run_prob), cs.time_ms(lib), cs.time_ms(lib), cs.time_ms(run_prob),
         cs.time_ms(run)]
    plain = cs.time_ms(lambda: aff.affinity_from_bank_plain(feats, labels, tgt, slots, **kw), reps=5)
    _, inv_sigma2, _ = aff.slot_table(slots, valid, dense, 8.0, 21.0, True)
    nbytes = k * 6420 * (c * 4 + 24 * 2) + 6420 * c * 4 + 24 * 6420 * 4
    b3, by3 = cs.affinity_bound(dev, k, 6420, 107, c, 22, inv_sigma2, nbytes, cs.PEAK_TF32_FLOPS, 3)
    bf, byf = cs.affinity_bound(dev, k, 6420, 107, c, 22, inv_sigma2, nbytes, cs.PEAK_F32_FLOPS)
    res = dict(ms=[float(t[0]), float(t[5])], prob_ms=[float(t[1]), float(t[4])],
               library_ms=[float(t[2]), float(t[3])], plain_ms=float(plain), bound_3xtf32_ms=b3, bound_ffma_ms=bf,
               worst=worst, cases=out)
    cs.log(f"bank 480p B=1: kernel {t[0]:.4f} / {t[5]:.4f} ms, probability mode {t[1]:.4f} / {t[4]:.4f} ms, "
           f"float32 sdpa {t[2]:.4f} / {t[3]:.4f} ms, plain {plain:.4f} ms; bound 3xTF32 {b3:.4f} ms ({by3}), "
           f"FFMA {bf:.4f} ms ({byf})")
    return res


def bottleneck_cases(torch, cs, dev, rng) -> dict:
    import torch.nn.functional as F

    from semi_supervised_vos_tpu_torch.ops.bottleneck import (bottleneck_block, bottleneck_block_plain,
                                                              tf32_split_weights)

    def library_block(x, k1, b1, k2, b2, k3, b3):
        y = torch.relu(F.conv2d(x, k1, b1))
        y = torch.relu(F.conv2d(y, k2, b2, padding=1))
        return torch.relu(F.conv2d(y, k3, b3) + x)

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for n, h, w, cc, c4, timed in ((8, 60, 107, 512, 128, True), (8, 60, 107, 1024, 256, True),
                                   (1, 13, 27, 512, 128, False), (3, 13, 27, 1024, 256, False),
                                   (1, 69, 123, 1024, 256, False), (1, 54, 97, 512, 128, False)):
        x = torch.as_tensor(rng.standard_normal((n, h, w, cc)), dtype=torch.float32).to(dev)
        shapes = [(cc, c4), (c4,), (3, 3, c4, c4), (c4,), (c4, cc), (cc,)]
        scales = [math.sqrt(2 / cc), 0.1, math.sqrt(2 / (9 * c4)), 0.1, math.sqrt(2 / c4), 0.1]
        wts = [torch.as_tensor(rng.standard_normal(sh) * sc, dtype=torch.float32).to(dev)
               for sh, sc in zip(shapes, scales)]
        planes = tf32_split_weights(wts[0], wts[2], wts[4])
        got = bottleneck_block(x, *wts, planes=planes)
        expect = bottleneck_block_plain(x, *wts)
        torch.cuda.synchronize()
        rel = ((got - expect).abs().max() / expect.abs().max()).item()
        name = f"N={n} {h}x{w} C={cc}"
        cs.log(f"bottleneck {name}: max_abs/max_ref={rel:.3e}")
        out[name] = dict(rel=rel)
        if timed:
            xl = x.permute(0, 3, 1, 2)
            lib = [wts[0].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[1],
                   wts[2].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last), wts[3],
                   wts[4].t()[:, :, None, None].contiguous(memory_format=torch.channels_last), wts[5]]
            run = lambda: bottleneck_block(x, *wts, planes=planes)  # noqa: E731
            runl = lambda: library_block(xl, *lib)  # noqa: E731
            t = [cs.time_ms(run), cs.time_ms(runl), cs.time_ms(runl), cs.time_ms(run)]
            ops = 2.0 * n * h * w * (cc * c4 + 9 * c4 * c4 + c4 * cc)
            nbytes = 4 * (2 * n * h * w * cc + 2 * cc * c4 + 9 * c4 * c4 + 2 * c4 + cc)
            b3 = cs.bound(3 * ops, nbytes, peak=cs.PEAK_TF32_FLOPS)
            bf = cs.bound(ops, nbytes, peak=cs.PEAK_F32_FLOPS)
            out[name].update(ms=[float(t[0]), float(t[3])], library_ms=[float(t[1]), float(t[2])],
                             bound_3xtf32_ms=b3[0], bound_ffma_ms=bf[0])
            cs.log(f"bottleneck {name}: kernel {t[0]:.4f} / {t[3]:.4f} ms, three float32 cuDNN convolutions "
                   f"{t[1]:.4f} / {t[2]:.4f} ms; bound 3xTF32 {b3[0]:.4f} ms ({b3[1]}), FFMA {bf[0]:.4f} ms")
        del x, got, expect
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from semi_supervised_vos_tpu_torch.ops import _build

    cs.log(cs.card_line())
    secs = _build.build(["affinity_bank", "affinity_bank_f32", "bottleneck_f32"])
    cs.log(f"built {secs}")
    for name in ("affinity_bank_f32", "bottleneck_f32"):
        for ln in ptxas_lines(name):
            cs.log(f"ptxas {name}: {ln}")
    cs.log(f"warpgroup products (cuobjdump -sass): {cs.tf32_wgmma_in_sass()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    result = dict(card=cs.card_line(), bottleneck=bottleneck_cases(torch, cs, dev, rng),
                  bank=bank_cases(torch, cs, dev, rng))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
