"""On-card smoke test of the PyTorch / CUDA port (one NVIDIA Hopper card).

    python3 chip_smoke.py

Phases, each printed as it runs (any failure exits non-zero, and the final
``{"ok": true, ...}`` line is printed only when every phase passed):

  1. device: the card's name and power limit, compute capability (9, 0),
     and the build of every CUDA kernel of the main path (nvcc, sm_90a);
  2. the bank-affinity kernel against its plain float32 version: the
     16x20-grid numerics recipe (single video, two lockstep videos, two
     row_base shards in stats mode, combined) and the 480p shape, timed;
  3. the fused bottleneck kernel against its plain float32 version at both
     480p geometries (C/C4 512/128 and 1024/256), N = 1 and 8, timed beside
     three cuDNN convolutions doing the same block;
  4. the BN-folded bf16 encoder (11 bottleneck launches) against the
     unfolded float32 module on one 480x854 frame;
  5. the main path: ``inference`` (default device) then ``evaluation`` on a
     synthetic 480p DAVIS tree with random resnet50 weights; the launch
     counters show that every frame went through both kernels; the card's
     masks are held against the CPU engine's on a small clip.

The line before the last is the card's name and power limit as nvidia-smi
reports them, the one before that a JSON summary of every kernel.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
AFFINITY_GATE = 3.4e-5  # max_abs of the bank kernel vs float32 (JAX on-chip gate)
STATS_GATE = 3.2e-5  # combined stats shards vs float32 (JAX on-chip gate)
ENCODER_MIN_COS = 0.9999
H480, W480 = 480, 854


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn``."""
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
    return statistics.median(times)


def bound(tensor_ops: float, nbytes: float, f32_ops: float = 0.0):
    """Least time (ms) for the work, and what sets it: bf16 tensor-core
    operations plus float32 operations (exps) at their peak rates, or the
    bytes at the memory rate."""
    t_ops = (tensor_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    def make_bank(p, b=1):
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
    # work this frame's data needs: the similarity over every sampled row,
    # the label product only where the prior is not below exp(-36)
    _, inv_sigma2, _ = aff.slot_table(slots, valid, dense, 8.0, 21.0, True)
    y = torch.arange(p, device=dev, dtype=torch.float32) / wd
    near = sum(int(((y[:, None] - y[None, :]) ** 2 * float(s) < 36.0).sum()) for s in inv_sigma2)
    ops = 2.0 * k * p * p * c + 2.0 * near * d
    exps = k * p * p + near  # e for every pair, the prior w where it is not skipped
    nbytes = k * p * (c + d_pad) * 2 + p * c * 4 + d_pad * p * 4
    b_ms, b_by = bound(ops, nbytes, exps)
    log(f"affinity 480p: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    res.update(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return res


# ---- phase 3: bottleneck -------------------------------------------------


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
    # the main path's encode batch (N = 8): 3 blocks at C=512 and 8 at C=1024
    batch = {key: 3 * per_geom[(512, 8)][key] + 8 * per_geom[(1024, 8)][key]
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"bottleneck per N=8 encode batch (11 launches): kernel {batch['ms']:.4f} ms, "
        f"plain {batch['plain_ms']:.4f} ms, library {batch['library_ms']:.4f} ms, bound {batch['bound_ms']:.4f} ms")
    return dict(max_abs_err=worst, bound_by=per_geom[(1024, 8)]["by"], **batch)


# ---- phases 4 and 5: encoder and main path --------------------------------


def random_vosnet(torch, seed: int):
    """resnet50 VOSNet with reference-style random weights and perturbed BN
    running statistics, drawn from one generator: the JAX package's recipe
    for its encoder gate. Its features all but share one direction (a
    per-pixel cosine of 0.999 to their mean), so label propagation with it
    returns background everywhere."""
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("resnet50").eval()
    g = torch.Generator().manual_seed(seed)
    init_weights(net, g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.normal_(0.0, 1.0, generator=g).abs_().mul_(0.5).add_(0.5)
    return net


def calibrated_vosnet(torch, dev, seed: int, frames_u8: np.ndarray):
    """resnet50 VOSNet whose features tell pixels apart, so that propagated
    masks carry the objects: random convolutions and perturbed BN affine
    parameters from one generator, each residual branch's last BN scale cut
    to a tenth, and the BN running statistics estimated on ``frames_u8``
    (one float32 pass in training mode), as a trained network's would be.
    Without the cut the random network is chaotic (bf16 rounding alone
    moves its features to a median cosine of 0.78)."""
    from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
    from semi_supervised_vos_tpu_torch.models.resnet import Bottleneck, init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet("resnet50")
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
        fast = fast_encode(table, x, torch.bfloat16).float()
        launches = bottleneck_block.launches
        ref = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    cos = torch.nn.functional.cosine_similarity(fast.reshape(-1, 256), ref.reshape(-1, 256), dim=-1)
    log(f"encoder 480x854: features {tuple(fast.shape)}, min per-pixel cosine {cos.min().item():.6f}, "
        f"bottleneck launches {launches}")
    check(bool(torch.isfinite(fast).all()) and cos.min().item() >= ENCODER_MIN_COS,
          f"encoder min cosine >= {ENCODER_MIN_COS}")
    check(launches == 11, "11 fused bottleneck launches per encode")


def main_path_phase(torch, dev, work: Path, net, videos: dict):
    from PIL import Image

    from semi_supervised_vos_tpu_torch.__main__ import cli
    from semi_supervised_vos_tpu_torch.eval.evaluation import evaluation_command_impl
    from semi_supervised_vos_tpu_torch.infer.strategies import chunk_len
    from semi_supervised_vos_tpu_torch.models.convert import save_torch_checkpoint
    from semi_supervised_vos_tpu_torch.ops.affinity import affinity_from_bank_batched
    from semi_supervised_vos_tpu_torch.ops.bottleneck import bottleneck_block

    ckpt, save = work / "resnet50.pth.tar", work / "pred"
    save_torch_checkpoint(net, ckpt)
    args = ["inference", "-d", str(work / "davis"), "-r", str(ckpt), "-s", str(save)]
    affinity_from_bank_batched.launches = 0
    bottleneck_block.launches = 0
    t0 = time.perf_counter()
    cli(args, standalone_mode=False)  # default --device: cuda
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"affinity_bank": affinity_from_bank_batched.launches,
                "bottleneck": bottleneck_block.launches}
    n_frames = sum(videos.values())
    chunk = chunk_len()
    encode_batches = sum(1 + math.ceil((n - 1) / chunk) for n in videos.values())
    log(f"main path: {n_frames} frames in {wall:.3f} s = {n_frames / wall:.3f} fps end to end; launches {launches}")
    for video, n in videos.items():
        pngs = sorted((save / video).glob("*.png"))
        check([p.name for p in pngs] == [f"{t:05d}.png" for t in range(n)], f"{video}: one PNG per frame ({n})")
        classes = sorted(set().union(*(np.unique(np.asarray(Image.open(p))).tolist() for p in pngs[1:])))
        check(classes == [0, 1, 2], f"{video}: the predicted masks carry both objects ({classes})")
    check(launches["affinity_bank"] == n_frames - len(videos), "one affinity launch per propagated frame")
    check(launches["bottleneck"] == 11 * encode_batches, f"11 bottleneck launches x {encode_batches} encode batches")
    j, f, jf = evaluation_command_impl(work / "davis" / "Annotations" / "480p", save)
    log(f"main path J={j:.6f} F={f:.6f} J&F={jf:.6f}")
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
    log(f"engine on the card, decoded frames: {ms:.4f} ms/frame ({1000.0 / ms:.3f} fps) over {n} frames")
    return ms


def small_clip_parity(torch, dev, net, work: Path):
    """Card (bf16, both kernels) vs CPU (float32, golden) engine masks on the
    long video's first 12 frames shrunk to 120x214, past a ring wrap
    (frame_range 6): they differ only where bf16 moves a near-tie."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    h, w, n = 120, 214, 12
    src = work / "davis"
    frames = np.stack([np.asarray(Image.open(src / "JPEGImages" / "480p" / "long" / f"{t:05d}.jpg")
                                  .resize((w, h), Image.BILINEAR)) for t in range(n)])
    label = np.asarray(Image.open(src / "Annotations" / "480p" / "long" / "00000.png")
                       .resize((w, h), Image.NEAREST)).astype(np.int32)
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
    log(f"small clip {h}x{w}, {n} frames: CPU mask classes {classes}, card vs CPU mask agreement {agree:.6f}")
    check(classes == [0, 1, 2], "the CPU engine's masks carry both objects")
    check(agree >= 0.98, "card masks agree with the CPU engine on >= 98% of pixels")


def main() -> int:
    if not (ROOT / "semi_supervised_vos_tpu_torch" / "__init__.py").is_file():
        log("FAILED: the semi_supervised_vos_tpu_torch package is not beside this script")
        return 2
    import torch

    if not torch.cuda.is_available():
        log("FAILED: no CUDA device")
        return 1
    sys.path.insert(0, str(ROOT))
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
            if "registers" in line or "spill" in line:
                log(f"  {name} ptxas: {line.strip()}")

    rng = np.random.default_rng(0)
    aff = affinity_phase(torch, dev, rng)
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
        encoder_phase(torch, dev, random_vosnet(torch, seed=0), frames[0])
        net = calibrated_vosnet(torch, dev, 0, frames)
        launches, fps, jf = main_path_phase(torch, dev, work, net, videos)
        engine_ms = engine_timing(torch, dev, net, work, "long", videos["long"])
        small_clip_parity(torch, dev, net, work)
    log(f"main path on {card}: {fps:.3f} fps end to end (CLI, decode and PNG writes included), "
        f"{engine_ms:.4f} ms/frame on the device (decoded frames), J&F {jf:.6f}")

    kernels = [
        dict(name="affinity_bank", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/affinity_bank.cu",
             replaces="semi_supervised_vos_tpu/ops/affinity_pallas.py:355", launches=launches["affinity_bank"], **aff),
        dict(name="bottleneck", route="cuda", source="semi_supervised_vos_tpu_torch/csrc/bottleneck.cu",
             replaces="semi_supervised_vos_tpu/ops/bottleneck_pallas.py:121", launches=launches["bottleneck"], **bott),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
