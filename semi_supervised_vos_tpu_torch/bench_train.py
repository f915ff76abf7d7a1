"""Training-step benchmark at the reference configuration, on the card.
The PyTorch counterpart of the JAX package's ``bench_train.py`` (at the
root of the repository).

    python -m semi_supervised_vos_tpu_torch.bench_train [--input-pipeline | --loss-families] [--device cuda|cpu]

The default mode times ``train/loop.py::make_train_step`` (resnet50
VOSNet, the cross-entropy label-propagation loss) at the reference
defaults, batch 16 of 10-frame clips of 256x256 crops
(``src/train.py:26-48``, ``src/utils/datasets.py:23``), on a batch staged
on the card: best and median over 6 passes (``SVOS_BENCH_PASSES``).
``SVOS_BENCH_DTYPE=bfloat16`` (the default) runs the forward under
bfloat16 autocast, the train CLI's ``--bf16``; ``float32`` runs the train
CLI's default precision. ``step_tflop`` counts the step: the convolutions of
the forward (forward hooks, ``utils/benchmarking.py::conv_flops``) and the
loss's two ``bmm`` (similarity and label product), each three times
(forward and backward); ``mfu`` is steps/s x that count over the bf16 dense
peak, 989 TFLOP/s, with the card's power limit under ``device``.

``--input-pipeline`` (or ``SVOS_BENCH_INPUT=1``) feeds the real
``data/davis.py::TrainDataset`` (JPEG and PNG decode, shared crop and
flips, stack) from a synthetic 480p tree on disk through the staging thread
into the train step: loader images/s and end-to-end steps/s, then the same
with the decoded-frame cache (``SVOS_DECODE_CACHE``; ``=0`` skips it).

``--loss-families`` (or ``SVOS_BENCH_LOSS=all`` or a comma list) times the
seven loss families, ``SVOS_BENCH_LOSS_PASSES`` (4) passes each.

Each mode prints ONE JSON line on stdout (the log goes to stderr). With
``--device cpu`` every time, rate and ``mfu`` is null; without a card the
default device is an error, never a CPU run.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import click
import numpy as np
import torch

from semi_supervised_vos_tpu_torch.bench import to_device
from semi_supervised_vos_tpu_torch.utils import benchmarking as bm

DATASET_ROOT = Path(__file__).resolve().parent.parent / "build" / "bench_davis"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class TrainProtocol:
    """What one run measures; :meth:`from_env` reads the JAX bench's knobs."""

    bs: int = 16
    frames: int = 10
    crop: int = 256
    passes: int = 6
    arch: str = "resnet50"
    bf16: bool = True
    loss_passes: int = 4

    @classmethod
    def from_env(cls) -> "TrainProtocol":
        dtype = os.environ.get("SVOS_BENCH_DTYPE", "bfloat16")
        if dtype not in ("bfloat16", "float32"):
            raise click.UsageError(f"SVOS_BENCH_DTYPE must be bfloat16 or float32, got {dtype!r}")
        return cls(passes=int(os.environ.get("SVOS_BENCH_PASSES", "6")), bf16=dtype == "bfloat16",
                   loss_passes=int(os.environ.get("SVOS_BENCH_LOSS_PASSES", "4")))

    @property
    def dtype(self) -> str:
        return "bfloat16" if self.bf16 else "float32"

    @property
    def shape_name(self) -> str:
        return f"bs{self.bs}_{self.frames}f_{self.crop}"


def synthetic_batch(rng, bs: int, frames: int, crop: int, second_object: bool = False):
    """The JAX bench's staged batch, the same bytes for the same generator
    state: random frames, one red object in the annotations (and a green
    one for the loss families: the miners need two classes)."""
    imgs = rng.integers(0, 255, (bs, frames, crop, crop, 3)).astype(np.uint8)
    anns = np.zeros((bs, frames, crop, crop, 3), np.uint8)
    anns[:, :, 64:160, 80:200] = [128, 0, 0]
    if second_object:
        anns[:, :, 180:220, 40:120] = [0, 128, 0]
    return imgs, anns


def step_flops(arch: str, bs: int, frames: int, crop: int, num_classes: int = 22) -> float:
    """Operations of one cross-entropy train step: the forward's
    convolutions over the bs x frames crops (counted on the meta device)
    plus the loss's similarity ``bmm`` (2·B·R·P²·C) and label product
    (2·B·R·P²·D), R = frames − 1 reference frames of P = (crop/8)² pixels,
    all three times (a backward is two products of the forward's size)."""
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial

    hd, wd = out_spatial(crop, crop)
    p, r = hd * wd, frames - 1
    loss = 2.0 * bs * r * p * p * (256 + num_classes)
    return 3.0 * (bs * frames * bm.vosnet_frame_flops(arch, (crop, crop)) + loss)


def make_step(net, spec, bf16: bool, dev) -> Callable:
    """``step(imgs, anns, *extra) -> loss``: the port's train step of
    ``net`` for ``spec`` with the train CLI's optimizer, the DAVIS centroids
    and a seeded generator bound."""
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import make_train_step
    from semi_supervised_vos_tpu_torch.train.train_state import make_optimizer

    step = make_train_step(net, spec, make_optimizer(net.parameters()), bf16=bf16)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    return lambda imgs, anns, *extra: step(imgs, anns, centroids, generator, *extra)


def _timed_steps(step, args, passes: int) -> list:
    """Seconds of each of ``passes`` steps, host clock to the loss's fetch
    (which waits for the card)."""
    times = []
    for p in range(passes):
        t0 = time.perf_counter()
        step(*args).item()
        times.append(time.perf_counter() - t0)
        log(f"pass {p}: {times[-1] * 1e3:.1f} ms")
    return times


def _build_disk_dataset(root, videos=2, frames=96, h=480, w=854):
    """Synthetic on-disk DAVIS-layout dataset at true 480p (JPEG images and
    palette-PNG annotations), the JAX bench's files: the point is to run the
    real decode, crop and flip loader, so the bytes come off disk through
    the real codecs."""
    from PIL import Image

    from semi_supervised_vos_tpu_torch.ops.onehot import davis_palette

    root = Path(root)
    marker = root / f".complete_{videos}x{frames}_{h}x{w}"
    if marker.exists():
        return root
    rng = np.random.default_rng(0)
    palette = davis_palette().reshape(-1).tolist()
    for v in range(videos):
        img_dir = root / "JPEGImages" / "480p" / f"video{v:02d}"
        ann_dir = root / "Annotations" / "480p" / f"video{v:02d}"
        img_dir.mkdir(parents=True, exist_ok=True)
        ann_dir.mkdir(parents=True, exist_ok=True)
        bg = rng.integers(0, 120, size=(h, w, 3), dtype=np.uint8)
        for t in range(frames):
            img = bg.copy()
            label = np.zeros((h, w), np.uint8)
            y, x = 80 + (3 * t) % 200, 120 + (5 * t) % 400
            img[y : y + 160, x : x + 240] = [210, 60 + v * 20, 50]
            label[y : y + 160, x : x + 240] = 1
            Image.fromarray(img).save(img_dir / f"{t:05d}.jpg", quality=90)
            ann = Image.fromarray(label, mode="P")
            ann.putpalette(palette)
            ann.save(ann_dir / f"{t:05d}.png")
    marker.touch()
    return root


def _rate(value: Optional[float], on_card: bool) -> Optional[float]:
    return value if on_card else None


def train_bench(proto: TrainProtocol, dev) -> dict:
    """Steps/s of the cross-entropy train step on a batch staged on the
    card (the card's rate, as a host feeding over PCIe or an on-card data
    pipeline would see it)."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec

    on_card = dev.type == "cuda"
    log(f"compute: {proto.dtype} ({'autocast' if proto.bf16 else 'float32 parameters and convolutions'})")
    net = build_train_net(proto.arch, dev)
    step = make_step(net, LossSpec(name="cross_entropy"), proto.bf16, dev)
    imgs, anns = synthetic_batch(np.random.default_rng(0), proto.bs, proto.frames, proto.crop)
    args = (to_device(imgs, dev), to_device(anns, dev))
    t0 = time.perf_counter()
    loss = step(*args).item()
    log(f"first step {time.perf_counter() - t0:.1f} s, loss {loss:.4f}")
    if not np.isfinite(loss):
        raise RuntimeError(f"the first step's loss is {loss}")
    times = _timed_steps(step, args, proto.passes)
    best, med = min(times), statistics.median(times)
    tflop = step_flops(proto.arch, proto.bs, proto.frames, proto.crop) / 1e12
    sps = _rate(1.0 / best, on_card)
    return {
        "metric": f"train_steps_per_sec_{proto.shape_name}",
        "value": sps,
        "unit": "steps/sec",
        "median_steps_per_sec": _rate(1.0 / med, on_card),
        "step_tflop": tflop,
        "effective_tflops": None if sps is None else tflop * sps,
        "mfu": bm.share_of_peak(sps, tflop * 1e12),
        "dtype": proto.dtype,
        "device": bm.device_record(dev),
        "protocol": f"{proto.shape_name} x {proto.passes} passes, cross_entropy",
    }


def input_pipeline_bench(proto: TrainProtocol, dev, root=DATASET_ROOT, tree=(2, 96, 480, 854)) -> dict:
    """The end-to-end training rate: the real ``TrainDataset`` (disk JPEG
    and PNG → decode → shared crop and flips → stack) through the staging
    thread (``train/loop.py::_device_stage``: pinned copies one step ahead)
    into the train step, against the staged ceiling of the default mode.
    Loader images/s and end-to-end steps/s, then both with the
    decoded-frame cache, whose first epoch only fills it."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.config import default_num_workers
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec, _device_stage, iterate_batches

    on_card = dev.type == "cuda"
    videos, frames, h, w = tree
    root = _build_disk_dataset(root, videos, frames, h, w)
    ann_root, img_root = root / "Annotations" / "480p", root / "JPEGImages" / "480p"
    dataset = TrainDataset(img_root, ann_root, cropping=proto.crop, frame_num=proto.frames)
    workers = default_num_workers()
    imgs_per_batch = proto.bs * proto.frames

    def loader_rate(ds):
        t0 = time.perf_counter()
        n = sum(imgs_per_batch for _ in iterate_batches(ds, proto.bs, num_workers=workers))
        return n / (time.perf_counter() - t0)

    loader_rates = []
    for _ in range(2):
        loader_rates.append(loader_rate(dataset))
        log(f"loader pass: {loader_rates[-1]:.1f} images/s ({workers} workers, host clock)")

    net = build_train_net(proto.arch, dev)
    step = make_step(net, LossSpec(name="cross_entropy"), proto.bf16, dev)
    first = next(iterate_batches(dataset, proto.bs, num_workers=workers))
    loss = step(to_device(first[0], dev), to_device(first[1], dev)).item()
    log(f"first step loss {loss:.4f}")

    def e2e_rate(ds):
        t0 = time.perf_counter()
        losses = [step(imgs, anns) for imgs, anns, _ in
                  _device_stage(iterate_batches(ds, proto.bs, num_workers=workers), dev)]
        torch.stack(losses).cpu()
        return len(losses) / (time.perf_counter() - t0)

    e2e_rates = []
    for p in range(2):
        e2e_rates.append(e2e_rate(dataset))
        log(f"e2e pass {p}: {e2e_rates[-1]:.3f} steps/s")

    cached_loader, cached_e2e = None, []
    if os.environ.get("SVOS_DECODE_CACHE", "1") != "0":
        try:
            dataset_c = TrainDataset(img_root, ann_root, cropping=proto.crop, frame_num=proto.frames,
                                     decode_cache=True)
            for _ in iterate_batches(dataset_c, proto.bs, num_workers=workers):
                pass  # the first epoch's cost: fills the cache
            cached_loader = loader_rate(dataset_c)
            log(f"cached loader pass: {cached_loader:.1f} images/s")
            for p in range(2):
                cached_e2e.append(e2e_rate(dataset_c))
                log(f"cached e2e pass {p}: {cached_e2e[-1]:.3f} steps/s")
        except MemoryError:
            cached_loader, cached_e2e = None, []
            log("decoded-frame cache skipped: MemoryError during its first epoch")
    else:
        log("decoded-frame cache skipped (SVOS_DECODE_CACHE=0)")

    best_loader = max(loader_rates)
    return {
        "metric": f"train_input_pipeline_{proto.shape_name}",
        "value": _rate(max(e2e_rates), on_card),
        "unit": "steps/sec",
        "loader_images_per_sec": _rate(best_loader, on_card),
        "loader_workers": workers,
        "images_per_step": imgs_per_batch,
        "loader_bound_steps_per_sec": _rate(best_loader / imgs_per_batch, on_card),
        "cached_loader_images_per_sec": _rate(cached_loader, on_card),
        "cached_steps_per_sec": _rate(max(cached_e2e), on_card) if cached_e2e else None,
        "dtype": proto.dtype,
        "device": bm.device_record(dev),
        "note": "real disk decode and augmentation feeding the real train step through the staging thread; "
                "cached_* = the decoded-frame cache (SVOS_DECODE_CACHE) after its first epoch",
    }


LOSS_FAMILIES = ("cross_entropy", "contrastive", "focal", "triplet_kernel", "triplet_temporal", "triplet_euclidean",
                 "triplet_skeleton")


def loss_specs() -> Dict[str, object]:
    """One spec per loss family; the triplet loss covers the three miner
    families: the kernel windows, the temporal miner and the morphology
    miners (distance transform, skeleton), which mine host geometry."""
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec
    from semi_supervised_vos_tpu_torch.train.miners import get_miner

    specs = {name: LossSpec(name=name) for name in ("cross_entropy", "contrastive", "focal")}
    for name, miner in (("kernel", "default"), ("temporal", "temporal"), ("euclidean", "euclidean"),
                        ("skeleton", "skeleton")):
        specs[f"triplet_{name}"] = LossSpec(name="triplet", miner=get_miner(miner))
    return specs


def loss_family_bench(proto: TrainProtocol, dev, selection: str = "all") -> dict:
    """Steps/s of every loss family on one staged batch with two objects,
    the weights threaded through all of them. The morphology miners run
    pipelined on the card: their host geometry is computed once here and
    staged on the card (the train loop computes it per batch on the staging
    thread, overlapped with the step), so each row is the step's rate."""
    from semi_supervised_vos_tpu_torch.cli.train import build_train_net
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import make_geometry_fn, mining_mode

    on_card = dev.type == "cuda"
    specs = loss_specs()
    if selection != "all":
        names = [s.strip() for s in selection.split(",")]
        specs = {k: v for k, v in specs.items() if k in names}
    net = build_train_net(proto.arch, dev)
    imgs, anns = synthetic_batch(np.random.default_rng(0), proto.bs, proto.frames, proto.crop, second_object=True)
    args = (to_device(imgs, dev), to_device(anns, dev))
    results = {}
    for name, spec in specs.items():
        step = make_step(net, spec, proto.bf16, dev)
        geometry_fn = make_geometry_fn(spec, davis_centroids(), dev)
        extra = () if geometry_fn is None else (tuple(to_device(g, dev) for g in geometry_fn(anns)),)
        t0 = time.perf_counter()
        loss = step(*args, *extra).item()
        log(f"{name} (mining={mining_mode(spec, dev)}): first step {time.perf_counter() - t0:.1f} s, loss {loss:.4f}")
        if not np.isfinite(loss):
            raise RuntimeError(f"{name}: the first step's loss is {loss}")
        times = _timed_steps(lambda *a: step(*a, *extra), args, proto.loss_passes)
        results[name] = {"steps_per_sec_best": _rate(1.0 / min(times), on_card),
                         "steps_per_sec_median": _rate(1.0 / statistics.median(times), on_card)}
    return {
        "metric": f"train_loss_family_steps_per_sec_{proto.shape_name}",
        "value": results.get("cross_entropy", {}).get("steps_per_sec_best"),
        "unit": "steps/sec (cross_entropy best)",
        "families": results,
        "dtype": proto.dtype,
        "device": bm.device_record(dev),
        "note": "one staged batch, the weights threaded through every family; the morphology miners' host "
                "geometry is staged once, so their rows are the step's rate",
    }


def _mode(input_pipeline: bool, loss_families: bool) -> Tuple[str, str]:
    """The mode and the loss selection, from the flags and the JAX bench's
    environment switches."""
    if input_pipeline or os.environ.get("SVOS_BENCH_INPUT") == "1":
        return "input", "all"
    if loss_families or os.environ.get("SVOS_BENCH_LOSS"):
        return "loss", os.environ.get("SVOS_BENCH_LOSS") or "all"
    return "train", "all"


@click.command()
@click.option("--input-pipeline", is_flag=True, help="Feed the real loader from a synthetic 480p tree on disk.")
@click.option("--loss-families", is_flag=True, help="Time the seven loss families.")
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda", show_default=True,
              help="cpu checks the code path and counts; its times are null.")
def main(input_pipeline: bool, loss_families: bool, device: str) -> None:
    """Train steps per second of the port at the reference configuration,
    as one JSON line."""
    if device == "cuda" and not torch.cuda.is_available():
        raise click.ClickException("no CUDA device: the bench measures the card (--device cpu checks the code path)")
    dev = torch.device(device)
    proto = TrainProtocol.from_env()
    mode, selection = _mode(input_pipeline, loss_families)
    log(f"device: {bm.device_record(dev)}; mode {mode}")
    if mode == "input":
        out = input_pipeline_bench(proto, dev)
    elif mode == "loss":
        out = loss_family_bench(proto, dev, selection)
    else:
        out = train_bench(proto, dev)
    print(json.dumps(out, allow_nan=False), flush=True)


if __name__ == "__main__":
    main()
