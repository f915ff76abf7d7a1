"""The card's own measurement of the inference hot path: propagated frames
per second at 480p DAVIS settings. The PyTorch counterpart of the JAX
package's ``bench.py`` (at the root of the repository).

    python -m semi_supervised_vos_tpu_torch.bench [--device cuda|cpu]

It times the whole hot path of the port: the BN-folded encoder with the
fused bottleneck kernel, the bank-affinity kernel reading the ring bank,
the in-place bank write and the argmax, at 480x854 with ref_num 9 and
frame_range 40 (the reference's inference defaults,
``src/inference.py:19-47``), with the masks drained to the host and
upsampled chunk by chunk as the CLI does (``infer/drain.py::MaskDrain``,
``ops/resize.py::nearest_resize_host``).

Protocol (the JAX bench's, with its knobs):
  * 64-frame synthetic videos (the 45-slot ring wraps), chunks of
    ``SVOS_BENCH_CHUNK`` (8) frames over the schedule
    ``1 + (t - 1) % (len - 1)``;
  * the single-stream engine and the lockstep engine at B =
    ``SVOS_BENCH_BATCH`` videos (8, or 2 at 1080p), each streamed from host
    memory and resident on the card (frames staged outside the timed
    window), interleaved over ``SVOS_BENCH_PASSES`` (4) passes; best and
    median;
  * ``phase_ms``: the backbone, the affinity op, the full device step,
    their residual and the mask copy to the host, in ms per frame on CUDA
    events;
  * ``strategy_fps`` (``SVOS_BENCH_STRATEGIES=1``, 480p only): every
    inference strategy through the port's engines at the card's rate
    (inputs on the card, masks left there until the last chunk);
  * ``SVOS_BENCH_FULL=1`` (480p only): the train-step pin (bs 16 x 10 x
    256², cross-entropy, run first, before any bank is allocated) and the
    1080p pin (the lockstep engine at B = 2, 24 frames, resident);
  * ``SVOS_BENCH_RES=1080`` measures 1080x1920 frames; with
    ``SVOS_BENCH_RESIDENT_ONLY=1`` the streamed variants are skipped;
  * on-card numerics: the bank kernel (single, lockstep and two stats
    shards joined by the combine kernel) on the 16x20 recipe against the
    float32 golden ``core/propagation.py::affinity_propagate``, the
    bottleneck-kernel encoder against the float32 module, and the sharded
    engines against the plain ones on a one-card mesh.

The features' dtype is ``SVOS_INFER_DTYPE`` (the CLI's). The weights are
random, from a seed: the work of a frame does not depend on them.

Prints ONE JSON line on stdout (the log goes to stderr). ``value`` is the
lockstep engine's best streamed pass (resident with
``SVOS_BENCH_RESIDENT_ONLY=1``). ``gflop_per_frame`` counts a frame's
convolutions and its affinity op (``utils/benchmarking.py``); ``mfu`` is
``value`` x that count over the bf16 dense peak, 989 TFLOP/s, with the
card's power limit under ``device``. With ``--device cpu`` every time, rate
and ``mfu`` is null and the counts and checks are filled in; without a card
the default device is an error, never a CPU run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import click
import numpy as np
import torch

from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

FRAMES = 64


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Protocol:
    """What one run measures; :meth:`from_env` reads the JAX bench's knobs."""

    res: str = "480"
    hw: Tuple[int, int] = (480, 854)
    frames: int = FRAMES
    chunk: int = 8
    passes: int = 4
    batch: int = 8
    full: bool = True  # the train pin and the 1080p pin
    strategies: bool = True
    resident_only: bool = False
    arch: str = "resnet50"
    train_shape: Tuple[int, int, int] = (16, 10, 256)  # clips, frames, crop
    hw_1080: Tuple[int, int] = (1080, 1920)
    frames_1080: int = 24
    batch_1080: int = 2
    check_hw: Tuple[int, int] = (128, 160)  # frames of the sharded-engine checks

    @classmethod
    def from_env(cls) -> "Protocol":
        res = os.environ.get("SVOS_BENCH_RES", "480")
        at_480 = res == "480"
        return cls(
            res=res,
            hw=(1080, 1920) if res == "1080" else (480, 854),
            chunk=int(os.environ.get("SVOS_BENCH_CHUNK", "8")),
            passes=int(os.environ.get("SVOS_BENCH_PASSES", "4")),
            batch=int(os.environ.get("SVOS_BENCH_BATCH", "2" if res == "1080" else "8")),
            full=at_480 and os.environ.get("SVOS_BENCH_FULL", "1") == "1",
            strategies=at_480 and os.environ.get("SVOS_BENCH_STRATEGIES", "1") == "1",
            resident_only=os.environ.get("SVOS_BENCH_RESIDENT_ONLY") == "1",
        )

    def describe(self) -> str:
        return f"{self.frames}f x {self.passes} passes, chunk {self.chunk}, batch {self.batch}"


def make_video(rng, n, h=480, w=854):
    """Synthetic frames with a moving textured square (keeps values finite
    and gives the propagation a real object to track): the JAX bench's
    bytes for the same generator state."""
    frames = rng.integers(0, 255, size=(n, h, w, 3), dtype=np.uint8)
    label0 = np.zeros((h, w), np.int32)
    label0[100:300, 200:500] = 1
    return frames, label0


# ---- device helpers ---------------------------------------------------------


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def device_ms(dev: torch.device, fn: Callable[[], object], reps: int = 20) -> Optional[float]:
    """Median CUDA-event ms of ``fn`` on the card; on the CPU ``fn`` runs
    once (its code path is checked) and the time is None."""
    if dev.type != "cuda":
        fn()
        return None
    return float(bm.time_ms(fn, reps=reps))


def _rates(vals: List[float], on_card: bool) -> Optional[Dict[str, float]]:
    """Best and median of host-clock rates; None off the card or when the
    variant did not run."""
    if not vals or not on_card:
        return None
    return {"best": max(vals), "median": statistics.median(vals)}


def link_probe(dev: torch.device) -> Tuple[Optional[float], Optional[float]]:
    """Host↔card copy rates (GB/s) of a pinned 16 MiB buffer, CUDA events
    around each copy: whether the streamed variants are bound by the link.
    (None, None) on the CPU."""
    if dev.type != "cuda":
        return None, None
    n = 16 << 20
    host = torch.empty(n, dtype=torch.uint8).pin_memory()
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    h2d = bm.time_ms(lambda: card.copy_(host, non_blocking=True), reps=10)
    d2h = bm.time_ms(lambda: host.copy_(card, non_blocking=True), reps=10)
    rates = n / (float(h2d) * 1e-3) / 1e9, n / (float(d2h) * 1e-3) / 1e9
    log(f"link: H2D {rates[0]:.3f} GB/s | D2H {rates[1]:.3f} GB/s (pinned 16 MiB)")
    return rates


# ---- numerics ---------------------------------------------------------------


def kernel_numerics_check(rng, dev: torch.device, bank_dtype: torch.dtype):
    """The bank kernel on the card against the float32 golden
    (``core/propagation.py::affinity_propagate`` on the CPU), on the JAX
    bench's 16x20 recipe past the ring's wrap: one video, two lockstep
    videos (lane 1 the first case), and two ``row_base`` stats shards joined
    by the combine kernel (``parallel/sharded_affinity.py``). The bank is
    bf16 (float32 under ``SVOS_INFER_DTYPE=float32``)."""
    from semi_supervised_vos_tpu_torch.core.propagation import affinity_propagate
    from semi_supervised_vos_tpu_torch.core.sampling import sample_frames
    from semi_supervised_vos_tpu_torch.core.spatial import spatial_weight
    from semi_supervised_vos_tpu_torch.ops.affinity import (
        affinity_from_bank,
        affinity_from_bank_batched,
        affinity_from_bank_stats,
    )
    from semi_supervised_vos_tpu_torch.parallel.sharded_affinity import distributed_softmax_combine

    hd, wd, c, d, d_pad = 16, 20, 256, 22, 24
    p = hd * wd
    cap, k, frame_idx = 45, 9, 50  # past wraparound, dense/sparse mix
    feats = (rng.standard_normal((cap, p, c)) * 0.2).astype(np.float32)
    cls = rng.integers(0, d, size=(cap, p))
    bank_l = np.zeros((cap, p, d_pad), np.float32)
    bank_l[np.arange(cap)[:, None], np.arange(p)[None, :], cls] = 1.0
    idx, valid, dense = sample_frames(frame_idx, 40, k)
    slots = idx % cap
    tgt = (rng.standard_normal((p, c)) * 0.2).astype(np.float32)

    expect = affinity_propagate(
        torch.as_tensor(feats[slots]), torch.as_tensor(tgt), torch.as_tensor(bank_l[slots][..., :d]),
        temperature=1.0, valid=torch.as_tensor(valid), dense=torch.as_tensor(dense),
        weight_dense=spatial_weight((hd, wd), 8.0), weight_sparse=spatial_weight((hd, wd), 21.0),
    )
    kw = dict(feature_hw=(hd, wd), temperature=1.0, valid=valid, dense=dense)
    t_dev = torch.as_tensor(tgt, device=dev)

    def on_dev(x, dtype=bank_dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dtype)

    def compare(got):
        got = got[:d].float().cpu()
        return float((got - expect).abs().max()), float((got.argmax(0) == expect.argmax(0)).double().mean())

    max_abs, agree = compare(affinity_from_bank(on_dev(feats), on_dev(bank_l, torch.bfloat16), t_dev, slots, **kw))
    log(f"kernel check: max_abs_diff={max_abs:.3e} argmax_agreement={agree:.4f}")

    bank_fb = np.swapaxes(np.stack([rng.permutation(feats), feats]), 0, 1)  # (cap, 2, P, C)
    bank_lb = np.swapaxes(np.stack([bank_l[::-1], bank_l]), 0, 1)
    got_b = affinity_from_bank_batched(on_dev(bank_fb), on_dev(bank_lb, torch.bfloat16),
                                       torch.stack([t_dev, t_dev]), slots, **kw)[1]
    b_max_abs, b_agree = compare(got_b)
    log(f"batched kernel check: max_abs_diff={b_max_abs:.3e} argmax_agreement={b_agree:.4f}")

    p_loc = p // 2
    stats = [
        affinity_from_bank_stats(on_dev(feats[:, s * p_loc:(s + 1) * p_loc]),
                                 on_dev(bank_l[:, s * p_loc:(s + 1) * p_loc], torch.bfloat16), t_dev, slots,
                                 row_base=s * p_loc, **kw)
        for s in range(2)
    ]
    sh_max_abs, sh_agree = compare(distributed_softmax_combine(*zip(*stats)))
    log(f"sharded stats kernel check (2 shards, combined): max_abs_diff={sh_max_abs:.3e} "
        f"argmax_agreement={sh_agree:.4f}")
    return ({"max_abs_diff": max_abs, "argmax_agreement": agree,
             "batched_max_abs_diff": b_max_abs, "batched_argmax_agreement": b_agree},
            {"stats_max_abs_diff": sh_max_abs, "stats_argmax_agreement": sh_agree})


def _check_clip(rng, hw, lanes: Optional[int] = None):
    """The sharded checks' 17 frames (with ``lanes``: of that many videos)
    and labels with two objects."""
    h, w = hw
    shape = (17, h, w, 3) if lanes is None else (17, lanes, h, w, 3)
    frames = rng.integers(0, 255, size=shape, dtype=np.uint8)
    labels = np.zeros(((lanes,) if lanes else ()) + (h, w), np.int32)
    labels[..., 30:80, 40:110] = 1
    if lanes is None:
        labels[90:120, 10:60] = 2
    else:
        labels[0, 90:120, 10:60] = 2
    return frames, labels


def _mask_agreement(first, second, frames) -> float:
    """Share of equal feature-resolution masks of two started (engine,
    state) pairs over the chunks at frames 1 and 9 (16 steps)."""
    (a, sa), (b, sb) = first, second
    agree = [(a.step_chunk_small(frames[s : s + 8], sa, s)[0] == b.step_chunk_small(frames[s : s + 8], sb, s)[0])
             .double().mean().item() for s in (1, 9)]
    return float(np.mean(agree))


def sharded_engine_check(rng, net, cfg, dev, hw) -> Dict[str, float]:
    """``parallel/engine_sharded.py::ShardedPropagationEngine`` on a
    one-card mesh (stats-mode bank kernel, then the combine kernel, then the
    sharded bank write) against ``PropagationEngine``: mask agreement over
    16 steps."""
    from semi_supervised_vos_tpu_torch.infer.engine import PropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.engine_sharded import ShardedPropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh

    frames, label0 = _check_clip(rng, hw)
    pairs = [(e, e.start_video(frames[0], label0))
             for e in (PropagationEngine(net, hw, cfg, dev), ShardedPropagationEngine(net, hw, cfg, Mesh([[dev]])))]
    agreement = _mask_agreement(*pairs, frames)
    log(f"sharded engine check: mask agreement {agreement:.4f}")
    return {"engine_mask_agreement": agreement}


def batched_sharded_check(rng, net, cfg, dev, hw) -> Dict[str, float]:
    """``parallel/batched_dp.py::BankShardedBatchedEngine`` (every lane's
    bank sharded over a one-card row: the batched stats kernel, the
    combine, the sharded write) against ``BatchedPropagationEngine``, two
    lanes, 16 steps."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.parallel.batched_dp import BankShardedBatchedEngine

    b = 2
    frames, labels0 = _check_clip(rng, hw, lanes=b)
    pairs = [(e, e.start_videos(frames[0], labels0))
             for e in (BatchedPropagationEngine(net, hw, b, cfg, dev), BankShardedBatchedEngine(net, hw, b, cfg, [dev]))]
    agreement = _mask_agreement(*pairs, frames)
    log(f"batched bank-sharded check: mask agreement {agreement:.4f}")
    return {"batched_engine_mask_agreement": agreement}


def encoder_check(rng, net, dtype, dev) -> float:
    """``models/infer_fast.py::fast_encode`` (BN folded, the bottleneck
    kernel on the card) against the unfolded module in full float32 on one
    64x64 input: the smallest per-pixel cosine."""
    from semi_supervised_vos_tpu_torch.models.fold import fold_vosnet
    from semi_supervised_vos_tpu_torch.models.infer_fast import _full_float32, fast_encode

    x = torch.as_tensor((rng.standard_normal((1, 64, 64, 3)) * 0.7).astype(np.float32), device=dev)
    with torch.no_grad():
        fast = fast_encode(fold_vosnet(net, dtype), x, dtype, arch=net.model).float()
        with _full_float32():
            ref = net(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    a = fast.reshape(-1, fast.shape[-1]).double().cpu().numpy()
    b = ref.reshape(-1, ref.shape[-1]).double().cpu().numpy()
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-9)
    log(f"fast-encoder check: min cosine {cos.min():.6f}")
    return float(cos.min())


# ---- the train pin ----------------------------------------------------------


def train_pin(rng, proto: Protocol, dev, bf16: bool) -> List[float]:
    """Steps/s of the port's train step (``train/loop.py::make_train_step``,
    cross-entropy) at ``proto.train_shape``, on a batch staged on the card:
    one warm step, then three timed ones (host clock to the loss's fetch).
    Runs before any inference engine allocates a bank (the step's
    activations need several GB); the full protocol is ``bench_train``."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    log("training pin ...")
    bs, t, crop = proto.train_shape
    net = build_train_net(proto.arch, dev)
    step = make_train_step(net, LossSpec(name="cross_entropy"), make_optimizer(net.parameters()), bf16=bf16)
    imgs = to_device(rng.integers(0, 255, (bs, t, crop, crop, 3)).astype(np.uint8), dev)
    anns = np.zeros((bs, t, crop, crop, 3), np.uint8)
    anns[:, :, 64:160, 80:200] = [128, 0, 0]
    anns = to_device(anns, dev)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    step(imgs, anns, centroids, generator).item()
    vals = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(imgs, anns, centroids, generator).item()
        vals.append(1.0 / (time.perf_counter() - t0))
    log(f"training pin: {max(vals):.4f} steps/s best (host clock)")
    del net, step, imgs, anns
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return vals


# ---- timed runs -------------------------------------------------------------


def _drain(mask_chunks, hw) -> List[np.ndarray]:
    """Drain (dispatch → fetch → host upsample) as a two-stage pipeline, as
    the CLI does: the loop queues every chunk at once while the drain's
    thread copies chunk t's feature-resolution masks to the host and
    upsamples them (the copy and the native upsampler release the GIL)
    during chunk t+1's device work."""
    from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    drain = MaskDrain()
    try:
        for masks in mask_chunks:
            drain.submit(lambda m=masks: nearest_resize_host(m.cpu().numpy(), hw, hw_axes=(-2, -1)))
        return drain.drain()
    finally:
        drain.close()


def _schedule(start: int, chunk: int, length: int) -> List[int]:
    """Frame indices of the chunk at ``start`` in a video of ``length``
    frames: ``1 + (t - 1) % (length - 1)``, so any run length reuses frames
    1 .. length - 1."""
    return [1 + (t - 1) % (length - 1) for t in range(start, start + chunk)]


def _timed_drain(engine, mask_chunks):
    """The timed window: ``mask_chunks`` (a generator that dispatches each
    chunk as it is drawn) drained to full resolution → (masks a second,
    the masks of each chunk)."""
    t0 = time.perf_counter()
    full = _drain(mask_chunks, (engine.h, engine.w))
    n = sum(f.size // (engine.h * engine.w) for f in full)
    return n / (time.perf_counter() - t0), full


def run_single(engine, frames, label0, n_frames: int = FRAMES, chunk: int = 8):
    """One timed pass of the single-stream engine over ``n_frames`` frames
    in ``chunk``-frame steps, frames from host memory (each chunk stacked
    and copied inside the timed window), masks drained to full resolution.
    Returns (frames/s, the (chunk, H, W) uint8 masks of each chunk)."""
    state = engine.start_video(frames[0], label0)
    _sync(engine.device)

    def gen():
        for start in range(1, 1 + n_frames, chunk):
            batch = frames[_schedule(start, chunk, len(frames))]
            yield engine.step_chunk_small(batch, state, start)[0]

    return _timed_drain(engine, gen())


def run_single_resident(engine, frames_dev, label0, n_frames: int = FRAMES, chunk: int = 8):
    """The card's rate: frames already on the card (staged outside the
    timed window), whole chunks only, so the chunk's shape never changes
    inside the window. Returns (frames/s, masks)."""
    state = engine.start_video(frames_dev[0], label0)
    starts = [s for s in range(1, 1 + n_frames, chunk) if s + chunk <= len(frames_dev)]
    chunks = [frames_dev[s : s + chunk] for s in starts]
    _sync(engine.device)
    return _timed_drain(engine, (engine.step_chunk_small(c, state, s)[0] for s, c in zip(starts, chunks)))


def run_batched(engine, frames_b, labels0_b, n_frames: int = FRAMES, chunk: int = 8):
    """The lockstep engine over B videos ((B, T, H, W, 3) frames in host
    memory) in ``chunk``-step chunks. Returns (lane-frames/s, the (chunk,
    B, H, W) uint8 masks of each chunk)."""
    state = engine.start_videos(frames_b[:, 0], labels0_b)
    _sync(engine.device)

    def gen():
        for start in range(1, 1 + n_frames, chunk):
            batch = np.stack([frames_b[:, t] for t in _schedule(start, chunk, frames_b.shape[1])])
            yield engine.step_chunk_small(batch, state, start)[0]

    return _timed_drain(engine, gen())


def run_batched_resident(engine, chunks_dev, first_frames, labels0_b, n_frames: int = FRAMES, chunk: int = 8):
    """The lockstep engine on (chunk, B, H, W, 3) chunks already on the
    card. Returns (lane-frames/s, masks)."""
    state = engine.start_videos(first_frames, labels0_b)
    _sync(engine.device)
    starts = range(1, 1 + n_frames, chunk)
    return _timed_drain(engine, (engine.step_chunk_small(c, state, s)[0] for s, c in zip(starts, chunks_dev)))


def batched_chunks(frames_b, n_frames: int, chunk: int, dev) -> List[torch.Tensor]:
    """The (chunk, B, H, W, 3) chunks of the lockstep schedule, on ``dev``."""
    return [to_device(np.stack([frames_b[:, t] for t in _schedule(start, chunk, frames_b.shape[1])]), dev)
            for start in range(1, 1 + n_frames, chunk)]


def phase_ms(engine, frames_dev, label0, chunk: int) -> Dict[str, Optional[float]]:
    """ms per frame on CUDA events, each phase alone on inputs already on
    the card and ``chunk`` frames a timing, as the step runs them: the
    backbone (one ``chunk``-frame encode), the affinity op (``chunk``
    propagations on a warm bank, frames 50 on, queued back to back), the
    full device step (a chunk of ``step_chunk_small``), the residual
    (write-back, argmax, the host's launch gaps) and the copy of a chunk's
    feature-resolution masks to the host. Nones on the CPU."""
    dev = engine.device
    fr = frames_dev[1 : 1 + chunk]
    backbone = device_ms(dev, lambda: engine._encode_chunk(fr))
    state = engine.start_video(frames_dev[0], label0)
    target = engine.encode(frames_dev[1:2])[0]
    affinity = device_ms(dev, lambda: [engine._propagate(target, state, 50 + i) for i in range(chunk)])
    masks = []
    step = device_ms(dev, lambda: masks.append(engine.step_chunk_small(fr, state, 50)[0]))
    d2h = device_ms(dev, lambda: masks[-1].cpu())
    if backbone is None:
        return dict.fromkeys(("backbone", "affinity", "full_step_device", "residual", "mask_d2h"))
    out = {"backbone": backbone / chunk, "affinity": affinity / chunk, "full_step_device": step / chunk,
           "mask_d2h": d2h / chunk}
    out["residual"] = out["full_step_device"] - out["backbone"] - out["affinity"]
    log("phase (ms/frame): " + " | ".join(f"{k} {v:.4f}" for k, v in out.items()))
    return out


def strategy_passes(net, cfg, dev, engine, frames, frames_dev, label0, n_frames: int, chunk: int):
    """One pass function per inference strategy, each at the card's rate:
    inputs staged on the card, masks (or fused masks) left there until the
    last chunk, frames/s of the video. The JAX bench's cost model: the flips
    run as two lockstep lanes fused on the card (``LaneFusion``), 2-scale
    two engines (1.0 and 1.15), hor-2-scale the second on mirrored input,
    3-scale three sequential passes (0.9, 1.0, 1.15), multimodel two
    engines of the same weights fused by the max of their argmaxes."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine, LaneFusion
    from semi_supervised_vos_tpu_torch.infer.engine import PropagationEngine

    h, w = engine.h, engine.w
    starts = list(range(1, 1 + n_frames, chunk))

    def timed(body):
        t0 = time.perf_counter()
        body()
        _sync(dev)
        return n_frames / (time.perf_counter() - t0)

    def pass_single():
        st = engine.start_video(frames_dev[0], label0)
        _sync(dev)
        return timed(lambda: [engine.step_chunk_small(frames_dev[s : s + chunk], st, s) for s in starts])

    def make_flip_pass(how):
        sl = (slice(None), slice(None), slice(None, None, -1)) if how == "h" else (slice(None), slice(None, None, -1))
        eng_f = BatchedPropagationEngine(net, (h, w), 2, cfg, dev, fusion=LaneFusion(pred_flips=(None, how)))
        frames_f = np.stack([frames[: 1 + n_frames], frames[: 1 + n_frames][sl]], axis=1)  # (T, 2, H, W, 3)
        labels_f = np.stack([label0, label0[sl[1:]]])
        chunks_f = [to_device(frames_f[s : s + chunk], dev) for s in starts]

        def pass_flip():
            st = eng_f.start_videos(frames_f[0], labels_f)
            _sync(dev)
            return timed(lambda: [eng_f.step_chunk(c, st, s) for s, c in zip(starts, chunks_f)])

        return pass_flip

    def scaled_video(sc):
        hs, ws = int(np.ceil(h * sc)), int(np.ceil(w * sc))
        ri, ci = (np.arange(hs) * h) // hs, (np.arange(ws) * w) // ws
        fr = frames[: 1 + n_frames][:, ri][:, :, ci]
        eng = engine if (hs, ws) == (h, w) else PropagationEngine(net, (hs, ws), cfg, dev)
        return eng, fr, label0[ri][:, ci], [to_device(fr[s : s + chunk], dev) for s in starts]

    s_115, s_090 = scaled_video(1.15), scaled_video(0.9)  # --scale default 1.15
    s_100 = (engine, frames[: 1 + n_frames], label0, [frames_dev[s : s + chunk] for s in starts])

    def two_streams(first, second, second_first_frame, second_label, second_chunks, scores=False):
        e1, f1, l1, c1 = first
        e2 = second
        st1, st2 = e1.start_video(f1[0], l1), e2.start_video(second_first_frame, second_label)
        _sync(dev)

        def body():
            for i, s in enumerate(starts):
                if scores:
                    x1, _ = e1.step_chunk_scores(c1[i], st1, s)
                    x2, _ = e2.step_chunk_scores(second_chunks[i], st2, s)
                    torch.maximum(torch.argmax(x1, dim=1), torch.argmax(x2, dim=1)).to(torch.uint8)
                else:
                    e1.step_chunk_small(c1[i], st1, s)
                    e2.step_chunk_small(second_chunks[i], st2, s)

        return timed(body)

    def pass_2_scale():
        return two_streams(s_100, s_115[0], s_115[1][0], s_115[2], s_115[3])

    fr115_m = np.ascontiguousarray(s_115[1][:, :, ::-1])
    chunks_115f = [to_device(fr115_m[s : s + chunk], dev) for s in starts]

    def pass_hor_2_scale():
        return two_streams(s_100, s_115[0], fr115_m[0], np.ascontiguousarray(s_115[2][:, ::-1]), chunks_115f)

    def pass_3_scale():
        states = [e.start_video(fr_[0], l0_) for e, fr_, l0_, _ in (s_090, s_100, s_115)]
        _sync(dev)

        def body():
            for (e, _, _, chunks), st in zip((s_090, s_100, s_115), states):
                for i, s in enumerate(starts):
                    e.step_chunk_small(chunks[i], st, s)

        return timed(body)

    mm_e2 = PropagationEngine(net, (h, w), cfg, dev)

    def pass_multimodel():
        return two_streams(s_100, mm_e2, s_100[1][0], label0, s_100[3], scores=True)

    return {"single": pass_single, "hor-flip": make_flip_pass("h"), "ver-flip": make_flip_pass("v"),
            "2-scale": pass_2_scale, "hor-2-scale": pass_hor_2_scale, "3-scale": pass_3_scale,
            "multimodel": pass_multimodel}


def fps_1080p(net, cfg, dev, rng, proto: Protocol) -> List[float]:
    """The lockstep engine at 1080x1920, B = ``proto.batch_1080`` videos,
    ``proto.frames_1080`` frames resident on the card: one warm pass, then
    three timed ones (lane-frames/s, host clock to a synchronise)."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine

    log("1080p pin ...")
    (h, w), b, n, chunk = proto.hw_1080, proto.batch_1080, proto.frames_1080, proto.chunk
    eng = BatchedPropagationEngine(net, (h, w), b, cfg, dev)
    videos = [make_video(rng, 1 + n, h, w) for _ in range(b)]
    frames_b = np.stack([v[0] for v in videos])
    labels = np.stack([v[1] for v in videos])
    chunks = batched_chunks(frames_b, n, chunk, dev)

    def one_pass():
        st = eng.start_videos(frames_b[:, 0], labels)
        _sync(dev)
        t0 = time.perf_counter()
        for i, s in enumerate(range(1, 1 + n, chunk)):
            eng.step_chunk_small(chunks[i], st, s)
        _sync(dev)
        return n * b / (time.perf_counter() - t0)

    one_pass()
    vals = [one_pass() for _ in range(3)]
    log(f"1080p pin: {max(vals):.3f} lane-frames/s best at B = {b}")
    del eng, chunks
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return vals


# ---- the run ---------------------------------------------------------------


def bench_net(arch: str, dev: torch.device, seed: int = 0):
    """A VOSNet of reference-initialised random weights from ``seed``, in
    eval mode on ``dev``."""
    from semi_supervised_vos_tpu_torch.models.resnet import init_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet(arch)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


def frame_gflop(arch: str, hw, cfg, frames: int, dev) -> float:
    """GFLOP of one propagated frame: its convolutions (counted on the meta
    device) and its affinity op (averaged over the run's frames)."""
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial

    hd, wd = out_spatial(*hw)
    return (bm.vosnet_frame_flops(arch, hw) + bm.propagation_flops_per_frame(cfg, hd, wd, frames, dev)) / 1e9


def run(proto: Protocol, device: str = "cuda") -> dict:
    """The whole protocol on ``device`` → the JSON line's object."""
    from semi_supervised_vos_tpu_torch.cli.inference import infer_dtype
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = infer_dtype(dev)
    device_info = bm.device_record(dev)
    log(f"device: {device_info}; features {dtype}; protocol {proto.describe()}")
    launches0 = bm.kernel_launches()
    rng = np.random.default_rng(0)
    h2d, d2h = link_probe(dev)
    kernel_check, sharded_check = kernel_numerics_check(rng, dev, dtype)

    net = bench_net(proto.arch, dev)
    cfg = EngineConfig(compute_dtype=dtype)
    sharded_check.update(sharded_engine_check(rng, net, cfg, dev, proto.check_hw))
    sharded_check.update(batched_sharded_check(rng, net, cfg, dev, proto.check_hw))

    # the train pin before any inference engine allocates its bank
    train_vals = train_pin(rng, proto, dev, bf16=dtype == torch.bfloat16) if proto.full else []
    kernel_check["encoder_min_cos"] = encoder_check(rng, net, dtype, dev)

    h, w = proto.hw
    chunk, n_frames = proto.chunk, proto.frames
    engine = PropagationEngine(net, (h, w), cfg, dev)
    frames, label0 = make_video(rng, 1 + max(n_frames, 3 * chunk), h, w)
    frames_b = np.stack([make_video(rng, 1 + n_frames, h, w)[0] for _ in range(proto.batch)])
    labels0_b = np.stack([label0] * proto.batch)
    bengine = BatchedPropagationEngine(net, (h, w), proto.batch, cfg, dev)

    if not proto.resident_only:
        log("warming the streamed variants ...")
        run_single(engine, frames, label0, chunk, chunk)
        run_batched(bengine, frames_b, labels0_b, chunk, chunk)
    frames_dev = to_device(frames, dev)
    run_single_resident(engine, frames_dev, label0, chunk, chunk)
    chunks_dev = batched_chunks(frames_b, n_frames, chunk, dev)
    run_batched_resident(bengine, chunks_dev, frames_b[:, 0], labels0_b, chunk, chunk)

    # variants interleaved, so that drift hits all four alike
    single, batched, resident, bresident = [], [], [], []
    for p in range(proto.passes):
        if not proto.resident_only:
            single.append(run_single(engine, frames, label0, n_frames, chunk)[0])
            batched.append(run_batched(bengine, frames_b, labels0_b, n_frames, chunk)[0])
        resident.append(run_single_resident(engine, frames_dev, label0, n_frames, chunk)[0])
        bresident.append(run_batched_resident(bengine, chunks_dev, frames_b[:, 0], labels0_b, n_frames, chunk)[0])
        log(f"pass {p}: " + (f"single {single[-1]:.2f} | batched {batched[-1]:.2f} | " if single else "")
            + f"device-resident {resident[-1]:.2f} | batched-resident {bresident[-1]:.2f} frames/s (host clock)")

    phases = phase_ms(engine, frames_dev, label0, chunk)

    strategy_fps = None
    if proto.strategies:
        passes = strategy_passes(net, cfg, dev, engine, frames, frames_dev, label0, n_frames, chunk)
        vals: Dict[str, List[float]] = {name: [] for name in passes}
        for name, fn in passes.items():
            log(f"warming strategy {name} ...")
            fn()
        for p in range(max(2, proto.passes // 2)):
            for name, fn in passes.items():
                vals[name].append(fn())
            log(f"strategy pass {p}: " + " | ".join(f"{k} {v[-1]:.2f}" for k, v in vals.items()) + " frames/s")
        strategy_fps = {name: _rates(v, on_card) for name, v in vals.items()}
        del passes

    vals_1080 = fps_1080p(net, cfg, dev, rng, proto) if proto.full else []

    value_runs = batched if batched else bresident
    value = max(value_runs) if on_card else None
    gflop = frame_gflop(proto.arch, proto.hw, cfg, n_frames, dev)
    launches1 = bm.kernel_launches()
    return {
        "metric": f"propagated_frames_per_sec_per_chip_{proto.res}p",
        "value": value,
        "unit": "frames/sec",
        "device": device_info,
        "dtype": str(dtype).replace("torch.", ""),
        "gflop_per_frame": gflop,
        "mfu": bm.share_of_peak(value, gflop * 1e9),
        "device_resident_fps": _rates(resident, on_card),
        "batched_fps": _rates(batched, on_card),
        "batched_resident_fps": _rates(bresident, on_card),
        "single_stream_fps": _rates(single, on_card),
        "phase_ms": phases,
        "strategy_fps": strategy_fps,
        "fps_1080p": dict(_rates(vals_1080, on_card), batch=proto.batch_1080) if vals_1080 and on_card else None,
        "train_steps_per_sec_bs16_10f_256": _rates(train_vals, on_card),
        "kernel_check": kernel_check,
        "sharded_kernel_check": sharded_check,
        "h2d_gb_s": h2d,
        "d2h_gb_s": d2h,
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "protocol": proto.describe(),
    }


@click.command()
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda", show_default=True,
              help="cpu checks the code path and counts; its times are null.")
def main(device: str) -> None:
    """Propagated frames per second of the port's inference hot path, as
    one JSON line."""
    if device == "cuda" and not torch.cuda.is_available():
        raise click.ClickException("no CUDA device: the bench measures the card (--device cpu checks the code path)")
    print(json.dumps(run(Protocol.from_env(), device), allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
