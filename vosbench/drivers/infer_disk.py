"""Inference from a DAVIS-layout tree on disk, as the CLI runs it one video
at a time: ``data/davis.py::InferenceDataset`` (its JPEG bytes read once,
each frame decoded on demand), ``data/loader.py::prefetch`` decoding ahead
on a thread pool, ``infer/strategies.py::run_streams`` over one stream (the
engine's chunks of ``chunk`` frames, the mask drain) and the palette PNGs
written at each video's end.

At set-up the traffic's seeded pool (``vosbench/videos.py``) is written once
as a tree under the checkout's ``build/`` directory:
``JPEGImages/480p/<video>/%05d.jpg`` at ``jpeg_quality`` and each video's
first-frame annotation as a palette PNG under ``Annotations/480p/``; the
dataset reads it, and every chunk shape the pool uses is warmed. The tree
and the warm-up's PNGs are then flushed to the disk (``fsync`` of each file
the run wrote), so that no write-back of set-up's pages falls in the window.
The window runs the tree video after video, each through ``run_streams``
into an output directory of its own (as a CLI run writes new files, never
over the last cycle's), and closes at the end of the first video that ends
past ``seconds``, its last PNG on disk. Only predicted frames count (a
video's frames but the first, whose mask is the copied annotation).

Each video of the window is timed on the host's clock: its wall seconds,
the seconds its frames spent being read and decoded (summed over the
prefetch threads), in the engine's ``step_chunk_small`` and in the PNG
writes, printed as the run's ``detail`` (``videos``: one row of
``video, frames, wall_s, decode_s, step_s, png_s`` a video, in order), so
that a drift of the rate inside a run shows and which term moved. A traced
run wraps the engine's layers as ``infer_stream.py`` does, and reads the
chunk dispatch's host time and the step's counted work over the videos
done before the slice.

The traffic's ``chunk`` sets the engine's chunk length (``SVOS_CHUNK``), as
for the CLI. It has no ``in_flight``: the CLI's ``run_streams`` puts no cap
on the chunks in flight (its mask drain queues without a bound, and the
engine's own queue on the card paces it), so the stream cell's cap of 2
has no counterpart on this path.

The masks are judged from the PNGs read back, against the reference fed the
JPEG pixels the program decoded (PIL's decode of the same files), and the
encoder's output for frames the last video's bank holds, as in
``infer_stream.py``. The tree goes when the run ends.

Traffic keys: ``hw``, ``video_batch`` (1), ``chunk``, ``pool``, ``lengths``
(lo, hi), ``objects``, ``jpeg_quality``, ``judge`` ({"videos", "frames"}).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from vosbench import counts, videos
from vosbench.drivers import infer_stream
from vosbench.harness import Context, Outcome
from vosbench.reference.judge import MaskJudge
from vosbench.reference.train import palette

CHECKOUT = Path(__file__).resolve().parents[2]


def write_tree(root: Path, pool: List[videos.Video], quality: int) -> List[str]:
    """The pool as a DAVIS-layout tree under ``root``; returns the videos'
    names, in pool order."""
    pal = palette().reshape(-1).tolist()
    names = []
    for i, v in enumerate(pool):
        name = f"v{i:02d}"
        img_dir = root / "JPEGImages" / "480p" / name
        ann_dir = root / "Annotations" / "480p" / name
        img_dir.mkdir(parents=True)
        ann_dir.mkdir(parents=True)
        for t in range(v.length):
            Image.fromarray(v.frames[t]).save(img_dir / f"{t:05d}.jpg", quality=quality)
        ann = Image.fromarray(v.label0.astype(np.uint8), mode="P")
        ann.putpalette(pal)
        ann.save(ann_dir / "00000.png")
        names.append(name)
    return names


def fsync_tree(root: Path) -> None:
    """Flush every file and directory under ``root`` (the run's own) to the
    disk."""
    for path in sorted(root.rglob("*")) + [root]:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


def decode(path: Path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


class _Clock:
    """Host seconds by term (``decode``, ``step``, ``png``), from any thread,
    taken and cleared once a video; and each step's end and length."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.steps: List[tuple] = []  # (perf_counter at its end, seconds)

    def add(self, term: str, t0: float) -> float:
        t1 = time.perf_counter()
        with self.lock:
            self.seconds[term] += t1 - t0
        return t1

    def take(self) -> Dict[str, float]:
        with self.lock:
            out, self.seconds = dict(self.seconds), defaultdict(float)
        return out

    def timed(self, term: str, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            t1 = self.add(term, t0)
            if term == "step":
                self.steps.append((t1, t1 - t0))
            return out

        return run


class _Video:
    """One video's items of the dataset, for ``run_streams``; each item's
    read and decode timed on ``clock``."""

    def __init__(self, dataset, lo: int, hi: int, clock: _Clock):
        self.dataset, self.lo, self.n, self.clock = dataset, lo, hi - lo, clock

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        t0 = time.perf_counter()
        item = self.dataset[self.lo + i]
        self.clock.add("decode", t0)
        return item


def run(ctx: Context) -> Outcome:
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import strategies
    from semi_supervised_vos_tpu_torch.infer.strategies import Stream, run_streams

    cfg, network, tr, dev, tracer = ctx.config, ctx.network, ctx.traffic, ctx.device, ctx.tracer
    if tr["video_batch"] != 1:
        raise ValueError("the disk driver runs one video at a time (video_batch 1)")
    on_card = torch.device(dev).type == "cuda"
    hw = tuple(tr["hw"])
    hd, wd = network.feature_hw(cfg, *hw)
    os.environ["SVOS_CHUNK"] = str(tr["chunk"])
    work = CHECKOUT / "build" / "vosbench_disk" / f"{os.getpid()}-{time.time_ns()}"
    clock = _Clock()
    save_predictions = strategies.save_predictions
    try:
        # the tree from the seed, read by the program's dataset
        pool = videos.make_pool(tr, ctx.seed, dev)
        names = write_tree(work / "davis", pool, tr["jpeg_quality"])
        lengths = [v.length for v in pool]
        del pool
        ctx.mark("tree written")
        jpegs = work / "davis" / "JPEGImages" / "480p"
        ann_dir = work / "davis" / "Annotations" / "480p"
        dataset = InferenceDataset(str(jpegs))
        bounds = np.cumsum([0] + lengths)
        views = [_Video(dataset, int(bounds[i]), int(bounds[i + 1]), clock) for i in range(len(names))]
        calib = torch.as_tensor(np.stack([decode(jpegs / n / "00000.jpg") for n in names[:4]]), device=dev)
        sd = network.inference_weights(cfg, ctx.seed, calib, dev)
        del calib
        ctx.mark("weights made")
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        engine = infer_stream.program(cfg, network, tr, sd, dev)
        engine.step_chunk_small = clock.timed("step", engine.step_chunk_small)
        strategies.save_predictions = clock.timed("png", save_predictions)
        stream = Stream(engine, None)
        ctx.mark("engine built")
        infer_stream._wrap(tracer, network)

        def make_streams(frame_hw, num_classes):
            if tuple(frame_hw) != hw or num_classes > engine.cfg.num_classes:
                raise ValueError(f"a video of {frame_hw} with {num_classes} classes: the tree holds {hw}")
            return [stream]

        # warm-up: every chunk length the pool's videos end on, then one whole
        # video through the path the window runs
        frames0 = np.stack([decode(jpegs / names[0] / f"{t:05d}.jpg") for t in range(tr["chunk"] + 1)])
        state = engine.start_video(frames0[0], np.asarray(Image.open(ann_dir / names[0] / "00000.png")))
        for n in sorted({(length - 1) % tr["chunk"] or tr["chunk"] for length in lengths} | {tr["chunk"]}):
            masks, state = engine.step_chunk_small(frames0[1:1 + n], state, 1)
            masks.cpu()
        run_streams(views[0], ann_dir, work / "warm", make_streams)
        if on_card:
            torch.cuda.synchronize(dev)
        tracer.warm(dev)
        fsync_tree(work)
        ctx.mark("shapes warmed, tree flushed")

        # the window
        slice_at, slice_end = ctx.slice_bounds()
        clock.take()
        clock.steps.clear()
        t0 = ctx.window_started()
        deadline = t0 + ctx.seconds
        done: List[int] = []
        ends: List[float] = []
        rows: List[list] = []
        out_of: Dict[int, Path] = {}  # video → the output directory of its last run
        while time.perf_counter() < deadline:
            v = len(done) % len(views)
            t_video = time.perf_counter()
            tracer.tick(t_video - t0, slice_at, slice_end, dev)
            out_of[v] = work / "out" / f"{len(done):04d}"
            with tracer.range("video"):
                run_streams(views[v], ann_dir, out_of[v], make_streams)
            ends.append(time.perf_counter())
            done.append(v)
            took = clock.take()
            rows.append([v, lengths[v] - 1, ends[-1] - t_video] + [took.get(k, 0.0) for k in ("decode", "step", "png")])
        t_end = ends[-1]
        ctx.window_closed()
        tracer.unwrap()
        trace_slice = tracer.finish(dev)
        strategies.save_predictions = save_predictions
        frames = sum(lengths[v] - 1 for v in done)
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        if trace_slice is not None:
            trace_slice.extra.update(_before_slice(cfg, network, hw, (hd, wd), done, ends, lengths, t0,
                                                   tracer.t_start, clock.steps))

        # the encoder's output for frames the last video's bank holds, then
        # the program's state goes before the reference runs
        last = done[-1]
        last_frames = np.stack([decode(jpegs / names[last] / f"{t:05d}.jpg") for t in range(lengths[last])])
        bank_frames, bank_feats = infer_stream._bank_sample(
            stream.state, [videos.Video(last_frames, np.zeros(hw, np.int64))], lengths[last] - 1,
            engine.cfg.capacity, False, tr["judge"]["frames"], ctx.seed)
        del engine, stream, state, last_frames
        if on_card:
            torch.cuda.empty_cache()

        judge = MaskJudge(sd, cfg, network, hw, (hd, wd), dev, control=ctx.control)
        judge.judge_features(bank_frames, bank_feats)
        _judge(judge, sorted(set(done)), names, lengths, jpegs, ann_dir, out_of, tr, ctx.seed)
        readings = MaskJudge.summary(judge.readings)
        return Outcome(attempted=frames, failed=0, metrics={"frames_per_s": (frames / (t_end - t0), "frames/s")},
                       readings=readings, memory_peak_bytes=int(peak), slice=trace_slice,
                       control=MaskJudge.summary(judge.control_readings),
                       extra={"detail": {"videos": [[int(r[0]), int(r[1])] + [round(x, 6) for x in r[2:]]
                                                    for r in rows]}})
    finally:
        strategies.save_predictions = save_predictions
        shutil.rmtree(work, ignore_errors=True)


def _before_slice(cfg, network, hw, feature_hw, done, ends, lengths, t0: float, t_slice: float, steps) -> dict:
    """The traced run's readings of the window before the slice opened, with
    the profiler off: the chunk dispatch's mean host seconds
    (``step_chunk_small``), and the counted work a second of the videos done
    by then (each predicted frame's encode and propagation)."""
    hd, wd = feature_hw
    before = [s for t, s in steps if t <= t_slice]
    finished = [v for v, t in zip(done, ends) if t <= t_slice]
    frame_flops, cache, work = network.frame_flops(cfg, *hw), {}, 0.0
    for v in finished:
        for t in range(1, lengths[v]):
            work += frame_flops + counts.propagation_flops(
                t, hd * wd, wd, cfg["feature_dim"], cfg["num_classes"], cfg["ref_num"], cfg["frame_range"],
                cfg["sigma_1"], cfg["sigma_2"], cache)
    last = max((t for t in ends if t <= t_slice), default=None)
    return {"num_classes": cfg["num_classes"], "dispatch_s": float(np.mean(before)) if before else None,
            "useful_flops_per_s": work / (last - t0) if last is not None and last > t0 else None}


def _judge(judge: MaskJudge, finished: List[int], names, lengths, jpegs: Path, ann_dir: Path,
           out_of: Dict[int, Path], tr: dict, seed: int) -> None:
    """Judge a sample, drawn from the seed, of the videos written in the
    window (the longest among them), from their PNGs on disk."""
    rng = np.random.default_rng([seed, 7])
    longest = max(finished, key=lambda v: (lengths[v], -v))
    rest = [v for v in finished if v != longest]
    picks = [longest] + [rest[i] for i in rng.permutation(len(rest))[: tr["judge"]["videos"] - 1]]
    for v in picks:
        name, length = names[v], lengths[v]
        others = rng.choice(np.arange(2, length - 1), size=tr["judge"]["frames"] - 2, replace=False)
        targets = sorted({1, length - 1, *map(int, others)})
        masks: Dict[int, np.ndarray] = {t: np.array(Image.open(out_of[v] / name / f"{t:05d}.png"))
                                        for t in range(1, length)}
        frames = np.stack([decode(jpegs / name / f"{t:05d}.jpg") for t in range(length)])
        label0 = np.asarray(Image.open(ann_dir / name / "00000.png")).astype(np.int64)
        judge.judge_video(frames, label0, masks, targets)
