"""The train and eval steps and the epoch loop (reference
``src/train.py:155-216``), the port's counterpart of the JAX package's
``train/loop.py``.

A step runs on the device from uint8 clips: normalisation, the backbone
over the B·T frames, the ×1/8 nearest downsample of the annotations,
centroid quantisation, one-hot reference labels, the loss (with its triplet
mining), the backward and the SGD update. Batches reach the device through
a staging thread (:func:`_device_stage`): pinned host memory, a copy on a
side stream, and, for pipelined morphology mining, the host geometry of the
batch, all one step ahead. Step losses stay on the device until the epoch
ends.

Precision: float32 parameters, gradients and loss products; convolutions
at PyTorch's defaults; ``bf16=True`` runs the forward under
``torch.autocast(bfloat16)``.

A train step records span ``train.step`` around ``train.forward`` (the
network to features), ``train.loss`` (the head, its miners included),
``train.backward`` and ``train.optimizer`` (the update, then the gradients
dropped), each timed on the card too (``utils/profiling.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.config import DEFAULT
from semi_supervised_vos_tpu_torch.infer.engine import IMAGENET_MEAN, IMAGENET_STD
from semi_supervised_vos_tpu_torch.ops.onehot import color_to_class, index_to_onehot
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize
from semi_supervised_vos_tpu_torch.train import losses
from semi_supervised_vos_tpu_torch.train.miners import (
    AbstractMiner,
    DistanceTransformationMiner,
    OneBackOneAheadMiner,
    SkeletonTemporalMiner,
    TemporalMiner,
    host_geometry,
)
from semi_supervised_vos_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """The loss and its hyper-parameters (``train.py:59-73``)."""

    name: str = "cross_entropy"
    temperature: float = 1.0
    margin: float = 0.1
    loss_weight: float = 1.0
    miner: Optional[AbstractMiner] = None


def mining_mode(spec: LossSpec, device) -> Optional[str]:
    """How the morphology miners run, or None for the other specs:
    ``pipelined`` on the card (host geometry on the staging thread, the
    picks on the device), ``callback`` (the host path) on the CPU; the
    ``SVOS_MINING`` environment variable overrides."""
    if not isinstance(spec.miner, DistanceTransformationMiner):
        return None
    env = os.environ.get("SVOS_MINING")
    if env is not None:
        if env not in ("pipelined", "callback"):
            raise ValueError(f"SVOS_MINING={env!r}: expected 'pipelined' or 'callback'")
        return env
    return "pipelined" if torch.device(device).type == "cuda" else "callback"


def host_ann_classes(anns: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """The step's annotation path on the host: (B, T, H, W, 3) uint8 →
    (B, T, H/8, W/8) class indices by the same nearest mapping and
    nearest-centroid rule as the device. ||x||² − 2x·c + ||c||² is a sum of
    integers below 2^24 here, exact in float32 in any order."""
    from semi_supervised_vos_tpu_torch.models.resnet import out_spatial
    from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize_host

    b, t, h, w, _ = anns.shape
    hd, wd = out_spatial(h, w)
    small = nearest_resize_host(anns.reshape(-1, h, w, 3), (hd, wd), hw_axes=(1, 2)).astype(np.float32)
    c = np.asarray(centroids, np.float32)
    dist = (small * small).sum(-1, keepdims=True) - 2.0 * small @ c.T + (c * c).sum(-1)
    return np.argmin(dist, axis=-1).reshape(b, t, hd, wd)


def mining_labels_host(anns: np.ndarray, centroids, miner) -> np.ndarray:
    """The label image the morphology miner mines, from the frames it needs
    only: the target frame, or for ``skeleton_temporal`` the last five
    frames stacked into one tall image."""
    if isinstance(miner, SkeletonTemporalMiner):
        ann_cls = host_ann_classes(anns[:, -5:], centroids)
        b, t, hd, wd = ann_cls.shape
        return ann_cls.transpose(0, 2, 1, 3).reshape(b, t * hd, wd)
    return host_ann_classes(anns[:, -1:], centroids)[:, 0]


def make_geometry_fn(spec: LossSpec, centroids, device):
    """``fn(anns) -> (interior, skel, nb_idx)``, the host geometry of one
    batch for pipelined mining (None in the other modes). It runs on the
    staging thread, so the SciPy work of batch t+1 overlaps step t."""
    if mining_mode(spec, device) != "pipelined":
        return None
    miner = spec.miner

    def geometry_fn(anns: np.ndarray):
        return host_geometry(mining_labels_host(anns, centroids, miner), miner.mode, miner.metric)

    return geometry_fn


def _miner_extras(feats, ann_cls, miner):
    """The frames each miner mines (``train.py:186-204``): feats
    (B, T, Hd, Wd, C), ann_cls (B, T, Hd, Wd) → (embeddings, labels), or
    (None, None) for the target frame."""
    if miner is None:
        return None, None
    b, t, hd, wd, c = feats.shape
    if isinstance(miner, OneBackOneAheadMiner):
        emb = torch.cat([feats[:, -5:-3], feats[:, -2:], feats[:, -3][:, None]], dim=1)
        lab = torch.cat([ann_cls[:, -5:-3], ann_cls[:, -2:], ann_cls[:, -3][:, None]], dim=1)
        return emb, lab
    if isinstance(miner, SkeletonTemporalMiner):
        emb = feats[:, -5:].permute(0, 2, 1, 3, 4).reshape(b, 5 * hd, wd, c)
        lab = ann_cls[:, -5:].permute(0, 2, 1, 3).reshape(b, 5 * hd, wd)
        return emb, lab
    if isinstance(miner, TemporalMiner):
        return feats[:, -5:], ann_cls[:, -5:]
    return None, None  # the kernel miners mine the target frame


def normalized_frames(imgs: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) uint8 clips → (B·T, 3, H, W) float32 frames,
    ImageNet-normalised (channels-last strides)."""
    dev = imgs.device
    x = imgs.reshape(-1, *imgs.shape[2:]).float() / 255.0
    x = (x - torch.as_tensor(IMAGENET_MEAN, device=dev)) / torch.as_tensor(IMAGENET_STD, device=dev)
    return x.permute(0, 3, 1, 2)


def features_from_embeddings(out: torch.Tensor, b: int, t: int) -> torch.Tensor:
    """(B·T, C, Hd, Wd) embeddings → (B, T, Hd, Wd, C) float32 features."""
    feats = out.float().permute(0, 2, 3, 1)
    return feats.reshape(b, t, *feats.shape[1:])


def make_head_fn(spec: LossSpec, num_classes: int = DEFAULT.num_classes):
    """Features to loss: ``head(feats, anns, centroids, generator,
    geometry=None)`` with feats (B, T, Hd, Wd, C) float32 and anns (B, T,
    H, W, 3) uint8 on one device: the annotations' ×1/8 nearest downsample
    and centroid quantisation (``train.py:166-172``), the one-hot reference
    labels and the loss."""

    def head(feats, anns, centroids, generator, geometry=None):
        b, t, hd, wd, c = feats.shape
        ann_small = nearest_resize(anns.reshape(-1, *anns.shape[2:]), (hd, wd))
        ann_cls = color_to_class(ann_small, centroids).reshape(b, t, hd, wd)

        ref, target = feats[:, : t - 1], feats[:, -1]
        ref_label = index_to_onehot(ann_cls[:, : t - 1], num_classes)
        target_label = ann_cls[:, -1]
        if spec.name == "cross_entropy":
            return losses.cross_entropy_loss(ref, target, ref_label, target_label, temperature=spec.temperature)
        if spec.name == "focal":
            return losses.focal_loss(ref, target, ref_label, target_label)
        if spec.name == "contrastive":
            return losses.contrastive_loss(ref, target, ref_label, target_label, temperature=spec.temperature)
        if spec.name == "triplet":
            extra_emb, extra_lab = _miner_extras(feats, ann_cls, spec.miner)
            return losses.triplet_loss_with_miner(
                ref, target, ref_label, target_label, spec.miner, generator=generator, extra_embeddings=extra_emb,
                extra_labels=extra_lab, margin=spec.margin, weights=(1.0, spec.loss_weight),
                temperature=spec.temperature, geometry=geometry,
            )
        raise RuntimeError("Invalid loss type.")

    return head


def make_loss_fn(spec: LossSpec, num_classes: int = DEFAULT.num_classes, bf16: bool = False):
    """``loss_fn(net, imgs, anns, centroids, generator, geometry=None)``:
    imgs and anns (B, T, H, W, 3) uint8 on the device; ``geometry`` is
    :func:`make_geometry_fn`'s output for the batch in pipelined mode.
    Forward to features, then :func:`make_head_fn`'s head. Train or eval
    follows ``net.training``."""
    head = make_head_fn(spec, num_classes)

    def loss_fn(net, imgs, anns, centroids, generator, geometry=None):
        with span("train.forward", device=imgs.device):
            with torch.autocast(imgs.device.type, dtype=torch.bfloat16, enabled=bf16):
                out = net(normalized_frames(imgs))
            feats = features_from_embeddings(out, *imgs.shape[:2])
        with span("train.loss", device=imgs.device):
            return head(feats, anns, centroids, generator, geometry)

    return loss_fn


def make_train_step(net, spec: LossSpec, optimizer, num_classes: int = DEFAULT.num_classes, bf16: bool = False):
    """``step(imgs, anns, centroids, generator, geometry=None) -> loss``: one
    optimizer step of ``net`` in train mode. Frozen parameters
    (``requires_grad`` off) get no gradient, so SGD leaves them, their weight
    decay and their momentum alone, as the JAX package's masked update
    does. The step drops the gradients once it has taken them: none is
    left on the parameters between steps."""
    loss_fn = make_loss_fn(spec, num_classes, bf16)

    def train_step(imgs, anns, centroids, generator, geometry=None):
        with span("train.step", device=imgs.device, new_id=True):
            loss = loss_fn(net, imgs, anns, centroids, generator, geometry)
            with span("train.backward", device=imgs.device):
                if loss.requires_grad:  # a frozen resnet18 has nothing to train
                    loss.backward()
            with span("train.optimizer", device=imgs.device):
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return train_step


def make_eval_step(net, spec: LossSpec, num_classes: int = DEFAULT.num_classes, bf16: bool = False):
    loss_fn = make_loss_fn(spec, num_classes, bf16)

    @torch.no_grad()
    def eval_step(imgs, anns, centroids, generator, geometry=None):
        return loss_fn(net, imgs, anns, centroids, generator, geometry)

    return eval_step


def iterate_batches(dataset, batch_size: int, drop_last: bool = True,
                    num_workers: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batches in order (the reference does not shuffle, ``train.py:88``).
    The augmentation of each item is drawn in this thread in index order
    (``TrainDataset.plan``), so the batches do not depend on
    ``num_workers``; with more than one worker the items decode on a thread
    pool, a bounded number ahead."""
    from semi_supervised_vos_tpu_torch.data.loader import prefetch_calls

    plans = (dataset.plan(i) for i in range(len(dataset)))
    if num_workers > 1:
        items = prefetch_calls(plans, depth=max(2 * num_workers, 8), workers=num_workers)
    else:
        items = (plan() for plan in plans)
    imgs_buf, anns_buf = [], []
    for imgs, anns, _ in items:
        imgs_buf.append(imgs)
        anns_buf.append(anns)
        if len(imgs_buf) == batch_size:
            yield np.stack(imgs_buf), np.stack(anns_buf)
            imgs_buf, anns_buf = [], []
    if imgs_buf and not drop_last:
        yield np.stack(imgs_buf), np.stack(anns_buf)


def _device_stage(loader, device, depth: int = 2, geometry_fn=None, mesh=None):
    """Bring batches to the device one step ahead, on a thread.

    On the card each batch is copied from pinned memory on a side stream
    (one a device), and the consumer's stream waits on the copy's event, so
    the copy of batch t+1 (63 MB of uint8 at bs 16 × 10 × 256²) and the
    decode loader overlap step t. ``geometry_fn`` (pipelined mining) runs on
    the thread too. With a ``mesh`` (``parallel/mesh.py``) the images and
    annotations are cut over its data rows by ``shard_batch``, each row's
    slice on the row's first device, and the geometry goes to the mesh's
    first device. Yields (imgs, anns, geometry or None): tensors, or per-row
    lists of them with a mesh."""
    import contextlib
    import queue
    import threading

    from semi_supervised_vos_tpu_torch.parallel.mesh import shard_batch

    device = torch.device(device) if mesh is None else mesh.devices[0][0]
    cuda = device.type == "cuda"
    devices = [device] if mesh is None else mesh.distinct_devices
    copy_streams = {d: torch.cuda.Stream(d) for d in devices} if cuda else {}
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()  # the consumer has gone: do not block

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def place(imgs, anns, geom):
        if mesh is not None:
            imgs, anns = shard_batch(mesh, imgs, anns, pin=cuda)
        else:
            imgs, anns = (torch.from_numpy(np.ascontiguousarray(a)) for a in (imgs, anns))
            if cuda:
                imgs, anns = (a.pin_memory().to(device, non_blocking=True) for a in (imgs, anns))
        geom = [torch.from_numpy(np.ascontiguousarray(g)) for g in geom]
        if cuda:
            geom = [g.pin_memory().to(device, non_blocking=True) for g in geom]
        return imgs, anns, geom

    def to_device(imgs, anns, geom):
        if not cuda:
            return place(imgs, anns, geom), []
        with contextlib.ExitStack() as streams:
            for s in copy_streams.values():
                streams.enter_context(torch.cuda.stream(s))
            out = place(imgs, anns, geom)
            events = []
            for d, s in copy_streams.items():
                events.append((d, torch.cuda.Event()))
                events[-1][1].record(s)
        return out, events

    def worker():
        try:
            for imgs, anns in loader:
                geom = geometry_fn(anns) if geometry_fn is not None else ()
                item = to_device(imgs, anns, geom)
                if not _put(item):
                    return
        except BaseException as e:  # raised again on the consumer's side
            err.append(e)
        finally:
            _put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            (imgs, anns, geom), events = item
            for d, event in events:
                torch.cuda.current_stream(d).wait_event(event)
            if events:
                flat = [*(imgs if mesh is not None else [imgs]), *(anns if mesh is not None else [anns]), *geom]
                for t in flat:
                    t.record_stream(torch.cuda.current_stream(t.device))
            yield imgs, anns, (tuple(geom) if geom else None)
    finally:
        stop.set()
        while True:  # free a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=5.0)
    if err:
        raise err[0]


def run_epoch(step_fn, loader, centroids, generator, device, progress: Optional[Callable[[], None]] = None,
              geometry_fn: Optional[Callable] = None, mesh=None) -> float:
    """One pass of ``step_fn`` over ``loader`` (reference ``step()``,
    ``train.py:155-216``); the mean loss, read from the device once at the
    end (NaN for an empty loader). With a ``mesh``, ``step_fn`` is a mesh
    step (``parallel/train_mesh.py``) and takes per-row lists."""
    step_losses = []
    for imgs, anns, geom in _device_stage(loader, device, geometry_fn=geometry_fn, mesh=mesh):
        extra = (geom,) if geom is not None else ()
        step_losses.append(step_fn(imgs, anns, centroids, generator, *extra))
        if progress:
            progress()
    if not step_losses:
        return float("nan")
    return float(np.mean(torch.stack(step_losses).cpu().numpy()))
