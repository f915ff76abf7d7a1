"""Inference as the CLI drives the engines: ``start_video`` /
``step_chunk_small`` of ``infer/engine.py::PropagationEngine`` for one video
at a time (``video_batch`` 1), ``start_videos`` / ``step_chunk_small`` of
``infer/batched.py::BatchedPropagationEngine`` for groups of videos in
lockstep, each chunk's masks fetched and upsampled to full resolution on
the host through ``infer/drain.py::MaskDrain`` and
``ops/resize.py::nearest_resize_host``.

The pool of decoded videos lives in host memory; each chunk's frames are
copied to the card inside the window. The loop is closed: video after
video (or group after group, in pool order, each run to its longest video,
a shorter lane repeating its last frame and padded to a whole last chunk as
``infer/batched.py::_run_group`` does), with at most ``in_flight`` chunks
dispatched and not yet drained. It dispatches until ``seconds`` have passed,
in lockstep to the end of the group then running (a chunk's share of real
frames depends on its place in the group, so a window cut inside a group
would move the rate with where it cut), and the window closes when the last
dispatched chunk's masks reach the host. Only real frames count.

Traffic keys: ``hw``, ``video_batch``, ``chunk``, ``in_flight``, ``pool``,
``lengths`` (lo, hi), ``objects``, ``judge`` ({"videos", "frames"}).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from vosbench import counts, videos
from vosbench.harness import Context, Outcome
from vosbench.reference.judge import MaskJudge


class _Chunk:
    __slots__ = ("inst", "t", "n", "real", "t_dispatch", "dispatched", "done", "masks", "error", "event")

    def __init__(self, inst: int, t: int, n: int, real: int):
        self.inst, self.t, self.n, self.real = inst, t, n, real
        self.t_dispatch = time.perf_counter()
        self.dispatched, self.done, self.masks, self.error = None, None, None, None
        self.event = threading.Event()


def _plan(lengths: List[int], chunk: int):
    """(t, n) of each chunk of a group: n real steps from frame t."""
    t_max, t, out = max(lengths), 1, []
    while t < t_max:
        n = min(chunk, t_max - t)
        out.append((t, n))
        t += n
    return out


def program(cfg: dict, network, tr: dict, sd, device):
    """The system under test: the VOS network loaded with ``sd`` and its
    engine, as the inference CLI builds them."""
    from semi_supervised_vos_tpu_torch.infer.batched import BatchedPropagationEngine
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, PropagationEngine

    net = network.program_net(cfg, sd, device)
    ecfg = EngineConfig(ref_num=cfg["ref_num"], frame_range=cfg["frame_range"], temperature=cfg["temperature"],
                        sigma_1=cfg["sigma_1"], sigma_2=cfg["sigma_2"], num_classes=cfg["num_classes"],
                        feature_dim=cfg["feature_dim"], compute_dtype=getattr(torch, cfg["inference_dtype"]))
    hw, b = tuple(tr["hw"]), tr["video_batch"]
    if b == 1:
        return PropagationEngine(net, hw, ecfg, device)
    return BatchedPropagationEngine(net, hw, b, ecfg, device)


def _wrap(tracer, network) -> None:
    """Ranges and call records around the program's layers (traced run):
    the engine's encode, the encoder's own (the family module's ``wrap``),
    the affinity op."""
    from semi_supervised_vos_tpu_torch.infer.engine import PropagationEngine
    from semi_supervised_vos_tpu_torch.ops import affinity

    tracer.wrap(PropagationEngine, "encode", "encode", lambda a, k: {"images": int(a[1].shape[0])})
    network.wrap(tracer)
    for name in ("affinity_bank_kernel<", "affinity_combine_kernel"):
        tracer.claim(name, ("affinity", "dispatch"))
    tracer.wrap(affinity, "affinity_from_bank_batched", "affinity", lambda a, k: {
        "lanes": int(a[0].shape[1]), "p": int(a[0].shape[2]), "c": int(a[0].shape[3]), "d_pad": int(a[1].shape[-1]),
        "valid": np.asarray(k["valid"], bool), "dense": np.asarray(k["dense"], bool), "hw": tuple(k["feature_hw"]),
        "sigma": (k.get("sigma_1", 8.0), k.get("sigma_2", 21.0)), "spatial": k.get("spatial", True)})


def run(ctx: Context) -> Outcome:
    from semi_supervised_vos_tpu_torch.infer.drain import MaskDrain
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    cfg, network, tr, dev, tracer = ctx.config, ctx.network, ctx.traffic, ctx.device, ctx.tracer
    on_card = torch.device(dev).type == "cuda"
    hw, b, chunk, in_flight = tuple(tr["hw"]), tr["video_batch"], tr["chunk"], tr["in_flight"]
    lockstep = b > 1
    axes = (2, 3) if lockstep else (1, 2)
    hd, wd = network.feature_hw(cfg, *hw)

    # inputs and weights from the seed
    pool = videos.make_pool(tr, ctx.seed, dev)
    if len(pool) % b:
        raise ValueError(f"a pool of {len(pool)} videos does not split into groups of {b}")
    groups = [pool[i:i + b] for i in range(0, len(pool), b)]
    ctx.mark("pool made")
    calib = torch.as_tensor(np.stack([v.frames[0] for v in pool[:4]]), device=dev)
    sd = network.inference_weights(cfg, ctx.seed, calib, dev)
    del calib
    ctx.mark("weights made")
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    engine = program(cfg, network, tr, sd, dev)
    ctx.mark("engine built")
    drain = MaskDrain()
    _wrap(tracer, network)

    def batch_of(group, t, n):
        if not lockstep:
            return group[0].frames[t:t + n]
        rows = [np.stack([v.frames[min(tt, v.length - 1)] for v in group]) for tt in range(t, t + n)]
        return np.stack(rows + [rows[-1]] * (chunk - n))

    def start(group):
        if lockstep:
            return engine.start_videos(np.stack([v.frames[0] for v in group]), np.stack([v.label0 for v in group]))
        return engine.start_video(group[0].frames[0], group[0].label0)

    def dispatch(c: _Chunk, state, frames):
        masks, state = engine.step_chunk_small(frames, state, c.t)
        # traced: the drain's range starts once the chunk's device work is
        # done, so that it holds the copy and the upsample alone
        ready = None
        if tracer.active and on_card:
            ready = torch.cuda.Event()
            ready.record()

        def convert(m=masks, c=c, ready=ready):
            try:
                if ready is not None:
                    ready.synchronize()
                t = time.perf_counter()
                c.masks = nearest_resize_host(m[:c.n].cpu().numpy(), hw, hw_axes=axes)
                if ready is not None:
                    # the profiler sees no range on this thread, which
                    # predates it: the drain keeps its own clock
                    tracer.calls["drain"].append({"s": time.perf_counter() - t})
            except Exception as e:  # noqa: BLE001 - raised again in the waiting thread
                c.error = e
            finally:
                c.done = time.perf_counter()
                c.event.set()

        drain.submit(convert)
        return state

    def wait(c: _Chunk) -> _Chunk:
        c.event.wait()
        if c.error is not None:
            raise c.error
        return c

    # warm-up: every chunk shape the pool uses, drained
    sizes = sorted({n for g in groups for _, n in _plan([v.length for v in g], chunk)})
    state = start(groups[0])
    for n in (sizes if not lockstep else [chunk]):
        c = _Chunk(-1, 1, n, 0)
        state = dispatch(c, state, batch_of(groups[0], 1, n))
        wait(c)
    drain.drain()
    if on_card:
        torch.cuda.synchronize(dev)
    tracer.warm(dev)
    ctx.mark("shapes warmed")

    # the window
    flops_cache: Dict = {}
    frame_flops = network.frame_flops(cfg, *hw)
    done: List[_Chunk] = []
    pending: deque = deque()
    slice_at, slice_end = ctx.slice_bounds()
    t0 = ctx.window_started()
    deadline = t0 + ctx.seconds
    inst, stop, written = 0, False, 0
    while not stop and time.perf_counter() < deadline:
        group = groups[inst % len(groups)]
        lens = [v.length for v in group]
        with tracer.range("start"):
            state = start(group)
        written = 0
        for t, n in _plan(lens, chunk):
            now = time.perf_counter()
            if now >= deadline and not lockstep:
                stop = True
                break
            tracer.tick(now - t0, slice_at, slice_end, dev)
            with tracer.range("wait"):
                while len(pending) >= in_flight:
                    done.append(wait(pending.popleft()))
            with tracer.range("stack"):
                frames = batch_of(group, t, n)
            c = _Chunk(inst, t, n, sum(max(0, min(n, length - t)) for length in lens))
            with tracer.range("dispatch"):
                state = dispatch(c, state, frames)
            c.dispatched = time.perf_counter()
            pending.append(c)
            written = t + len(frames) - 1
        inst += 1
    while pending:
        done.append(wait(pending.popleft()))
    drain.drain()
    drain.close()
    t_end = max(c.done for c in done)
    ctx.window_closed()
    window = t_end - t0
    tracer.unwrap()
    trace_slice = tracer.finish(dev)

    real = sum(c.real for c in done)
    lat = np.array([c.done - c.t_dispatch for c in done]) * 1e3
    # the traced run's rate: the chunks done before the slice opened
    counted = done if tracer.t_start is None else [c for c in done if c.done <= tracer.t_start]
    useful_flops = 0.0
    for c in counted:
        for length in [v.length for v in groups[c.inst % len(groups)]]:
            for t in range(c.t, min(c.t + c.n, length)):
                useful_flops += frame_flops + counts.propagation_flops(
                    t, hd * wd, wd, cfg["feature_dim"], cfg["num_classes"], cfg["ref_num"], cfg["frame_range"],
                    cfg["sigma_1"], cfg["sigma_2"], flops_cache)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    # the encoder's output for frames still in the bank, then the program's
    # state goes before the reference runs
    bank_frames, bank_feats = _bank_sample(state, groups[(inst - 1) % len(groups)], written, engine.cfg.capacity,
                                           lockstep, tr["judge"]["frames"], ctx.seed)
    del engine, state
    if on_card:
        torch.cuda.empty_cache()

    judge = MaskJudge(sd, cfg, network, hw, (hd, wd), dev, control=ctx.control)
    judge.judge_features(bank_frames, bank_feats)
    _judge(judge, done, groups, tr, ctx.seed)
    readings = MaskJudge.summary(judge.readings)

    metrics = {"frames_per_s": (real / window, "frames/s"),
               "chunk_p90_ms": (float(np.percentile(lat, 90)), "ms")}
    if trace_slice is not None:
        pre = max(c.done for c in counted) - t0
        # host time of the dispatches before the slice, with the profiler off
        before = [c.dispatched - c.t_dispatch for c in done if c.dispatched <= tracer.t_start]
        trace_slice.extra.update({"useful_flops_per_s": useful_flops / pre, "num_classes": cfg["num_classes"],
                                  "dispatch_s": float(np.mean(before)) if before else None})
    return Outcome(attempted=real, failed=0, metrics=metrics, readings=readings, memory_peak_bytes=int(peak),
                   slice=trace_slice, control=MaskJudge.summary(judge.control_readings),
                   extra={"chunk_p90_ms": {"samples": int(len(lat))}})


def _judge(judge: MaskJudge, done: List[_Chunk], groups, tr: dict, seed: int) -> None:
    """Judge a sample, drawn from the seed, of the videos that finished in
    the window, the longest among them."""
    masks: Dict[tuple, Dict[int, np.ndarray]] = {}
    for c in done:
        group = groups[c.inst % len(groups)]
        for i, v in enumerate(group):
            for k in range(c.n):
                if c.t + k < v.length:
                    masks.setdefault((c.inst, i), {})[c.t + k] = c.masks[k, i] if len(group) > 1 else c.masks[k]
    finished = [key for key, m in masks.items()
                if len(m) == groups[key[0] % len(groups)][key[1]].length - 1]
    if not finished:
        raise RuntimeError("no video finished in the window")
    rng = np.random.default_rng([seed, 7])
    length = {key: groups[key[0] % len(groups)][key[1]].length for key in finished}
    longest = max(finished, key=lambda k: (length[k], -k[0]))
    rest = [k for k in finished if k != longest]
    picks = [longest] + [rest[i] for i in rng.permutation(len(rest))[: tr["judge"]["videos"] - 1]]
    for key in picks:
        v = groups[key[0] % len(groups)][key[1]]
        # frame 1, whose only reference is the annotation, the last, and
        # others drawn from the seed
        others = rng.choice(np.arange(2, v.length - 1), size=tr["judge"]["frames"] - 2, replace=False)
        judge.judge_video(v.frames, v.label0, masks[key], sorted({1, v.length - 1, *map(int, others)}))


def _bank_sample(state, group, written: int, capacity: int, lockstep: bool, n: int, seed: int):
    """A sample, drawn from the seed, of the frames whose features the bank
    of the last group holds (frames ``written`` − capacity + 1 ..
    ``written``): (their (n, H, W, 3) frames, the bank's (n, P, C) rows of
    them)."""
    rng = np.random.default_rng([seed, 11])
    held = np.arange(max(0, written - capacity + 1), written + 1)
    frames = sorted(rng.choice(held, size=min(n, len(held)), replace=False).tolist())
    lanes = rng.integers(0, len(group), size=len(frames)) if lockstep else [0] * len(frames)
    pix, feats = [], []
    for f, lane in zip(frames, lanes):
        v = group[lane]
        pix.append(v.frames[min(f, v.length - 1)])
        row = state.feats[f % capacity]
        feats.append((row[lane] if lockstep else row).float().clone())
    return np.stack(pix), torch.stack(feats)
