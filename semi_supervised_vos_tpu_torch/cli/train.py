"""`train` command: the JAX package's CLI surface (reference
``src/train.py:25-49``) on the PyTorch train loop.

``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
card raises. The mesh follows the JAX CLI's rules (``cli/train.py:184-230``
there), over every card under ``--device cuda`` and the one CPU under
``--device cpu``: data parallelism when the batch divides over the
data-parallel degree ``n_devices / --tp``, channel sharding with ``--tp``
> 1, both on a 2-D mesh (``parallel/train_mesh.py``, ``parallel/tp.py``).
Checkpoints are reference-format ``.pth.tar`` files
(``train/train_state.py``), gathered to the single-device layout.
``SVOS_PROFILE=1`` and ``SVOS_TRACE_DIR`` act as for ``inference``: the
train step's spans (``train.step``, ``train.forward``, ``train.loss``,
``train.backward``, ``train.optimizer``, timed on the card too) in one
``phase timing`` line at the end, a Chrome trace of the run.
"""

from __future__ import annotations

import math
from pathlib import Path

import click

from semi_supervised_vos_tpu_torch.utils.logging import logger

MINER_CHOICES = [
    "default", "kernel_7x7", "temporal", "one_back_one_ahead",
    "euclidean", "manhattan", "chebyshev", "skeleton",
    "skeleton_nearest_negative", "skeleton_temporal",
]
LOSS_CHOICES = ["cross_entropy", "focal", "contrastive", "triplet"]


@click.command(name="train")
@click.option("--frame_num", "-n", type=int, default=10, help="Number of frames to train.")
@click.option("--train", "-t", "training", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to training dataset.")
@click.option("--val", "-v", "validation", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to validation dataset.")
@click.option("--resume", "-r", type=click.Path(dir_okay=True, file_okay=True), help="Path to the trained checkpoint.")
@click.option("--save_model", "-m", type=click.Path(dir_okay=True, file_okay=False), default="./checkpoints",
              help="Directory to save checkpoints.")
@click.option("--epochs", type=int, default=240, help="Number of epochs.")
@click.option("--bs", type=int, default=16, help="Batch size.")
@click.option("--lr", type=float, default=0.02, help="Initial learning rate.")
@click.option("--loss", type=click.Choice(LOSS_CHOICES), default="cross_entropy", help="Loss function to use.")
@click.option("--freeze/--no-freeze", default=False, help="Whether or not freeze the feature extractor backbone.")
@click.option("--miner", type=click.Choice(MINER_CHOICES), default="default", help="Triplet loss miner.")
@click.option("--margin", type=click.FloatRange(min=0.0, max=1.0), default=0.1, help="Triplet loss margin.")
@click.option("--loss_weight", type=click.FloatRange(min=0.0), default=1.0, help="Weight of triplet loss.")
@click.option("--max_triplets", type=click.IntRange(min=0), default=0,
              help="Maximum number of triplets to mine (0 means take all triplets).")
@click.option("--early-stop/--no-early-stop", default=False, help="Whether or not use the early stopping for training.")
@click.option("--model", "model_name",
              type=click.Choice(["resnet18", "resnet50", "resnet101", "facebook", "dino_vitb8", "sam2_hiera_l"]),
              default="resnet50",
              help="Backbone (dino_vitb8 and sam2_hiera_l are refused: their features are used frozen).")
@click.option("--pretrained", type=click.Path(file_okay=True, dir_okay=False), default=None,
              help="Local torchvision ImageNet checkpoint for the backbone (fc dropped; layer4 too but for facebook).")
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda", help="Device to run computing on.")
@click.option("--bf16/--no-bf16", default=False,
              help="bfloat16 autocast over the forward (float32 parameters and gradients).")
@click.option("--tp", type=click.IntRange(min=1), default=1,
              help="Tensor-parallel degree: channel-shard the backbone over the mesh's model axis (composes with "
                   "data parallelism over the remaining devices).")
@click.option("--decode-cache/--no-decode-cache", default=None,
              help="Keep decoded frames in host RAM after the first epoch. Default: the SVOS_DECODE_CACHE env var.")
def train_command(frame_num, training, validation, resume, save_model, epochs, bs, lr, loss, freeze, miner, margin,
                  loss_weight, max_triplets, early_stop, model_name, pretrained, device, bf16, tp, decode_cache):
    from semi_supervised_vos_tpu_torch.utils.profiling import profiled_run

    try:
        with profiled_run():
            train_command_impl(frame_num, training, validation, resume, save_model, epochs, bs, lr, loss, freeze,
                               miner, margin, loss_weight, max_triplets, early_stop, model_name, pretrained, device,
                               bf16=bf16, tp=tp, decode_cache=decode_cache)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        raise click.ClickException(str(err)) from err


def mesh_devices(dev, devices=None) -> list:
    """The devices a mesh may use: ``devices`` when given (tests and
    ``chip_smoke.py`` pass ``[cpu] * 8`` or ``[cuda:0] * k``), else every
    card under ``--device cuda`` and the one CPU under ``--device cpu`` (a
    JAX host without virtual devices)."""
    import torch

    if devices is not None:
        return [torch.device(d) for d in devices]
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def train_mesh_shape(n_dev: int, tp: int, bs: int):
    """The JAX train CLI's rules, word for word: (n_data, n_model) of the
    mesh, or None to run on one device."""
    if tp < 1 or tp > n_dev:
        raise click.ClickException(f"--tp {tp} must be between 1 and the {n_dev} available device(s).")
    if n_dev % tp != 0:
        raise click.ClickException(
            f"--tp {tp} must divide the device count ({n_dev}); {n_dev % tp} device(s) would sit idle.")
    n_data = n_dev // tp
    if bs % n_data != 0:
        if tp > 1:
            raise click.ClickException(
                f"--tp {tp} needs batch size divisible by the data-parallel degree {n_data} (got --bs {bs}).")
        if n_dev > 1:
            logger.warning(f"batch size {bs} does not divide over {n_data} devices; "
                           "running single-device (pick a divisible --bs to engage the mesh)")
    if n_dev > 1 and bs % n_data == 0:
        return n_data, tp
    return None


def make_spec(loss: str, miner: str, margin: float, loss_weight: float, max_triplets: int = 0):
    from semi_supervised_vos_tpu_torch.train.loop import LossSpec
    from semi_supervised_vos_tpu_torch.train.miners import get_miner

    miner_obj = None
    if loss == "triplet":
        miner_obj = get_miner(miner)
        if miner_obj is None:
            raise RuntimeError("Invalid miner type.")
        miner_obj.max_triplets = max_triplets
    return LossSpec(name=loss, temperature=1.0, margin=margin, loss_weight=loss_weight, miner=miner_obj)


def build_train_net(model_name: str, dev, pretrained=None):
    """VOSNet initialised as the JAX train CLI does (``init_train_weights``
    from seed 42), then the ImageNet backbone from ``pretrained`` if given,
    on ``dev`` (channels-last on the card, for cuDNN's NHWC kernels)."""
    import torch

    from semi_supervised_vos_tpu_torch.models.resnet import init_train_weights
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet

    net = VOSNet(model_name)
    init_train_weights(net, torch.Generator().manual_seed(42))
    if pretrained is not None:
        from semi_supervised_vos_tpu_torch.models.convert import load_torchvision_backbone

        load_torchvision_backbone(net, torch.load(pretrained, map_location="cpu", weights_only=True))
    net = net.to(dev)
    if dev.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    return net


def train_command_impl(frame_num, training, validation, resume, save_model, epochs, bs, lr, loss, freeze, miner,
                       margin, loss_weight, max_triplets, early_stop, model_name="resnet50", pretrained=None,
                       device="cuda", disable=False, crop=256, bf16=False, tp=1, decode_cache=None, devices=None):
    """Reference ``src/train.py:49-152``; returns the trained network.
    ``devices``: the mesh's devices in place of every card (or the CPU)."""
    import torch

    from semi_supervised_vos_tpu_torch.models.vos_net import FROZEN_NAMES

    if model_name in FROZEN_NAMES:
        raise NotImplementedError(f"training {model_name} is not ported: its features are used frozen "
                                  f"(the reference trains only its stride-8 ResNets); run inference with it")

    from semi_supervised_vos_tpu_torch.config import default_num_workers
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.early_stopping import EarlyStopping
    from semi_supervised_vos_tpu_torch.train.loop import (
        iterate_batches,
        make_eval_step,
        make_geometry_fn,
        make_train_step,
        run_epoch,
    )
    from semi_supervised_vos_tpu_torch.train.train_state import (
        checkpoint_name,
        cosine_lr,
        load_weights,
        make_optimizer,
        save_checkpoint,
        set_learning_rate,
    )
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    devices = mesh_devices(dev, devices)
    n_dev = len(devices)
    shape = train_mesh_shape(n_dev, tp, bs)
    mesh = None
    if shape is not None:
        from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(*shape, devices=devices)
    dev = devices[0]
    logger.info("Training started.")
    spec = make_spec(loss, miner, margin, loss_weight, max_triplets)

    if pretrained is None and resume is None:
        # the reference's out-of-box ImageNet initialisation, random offline
        from semi_supervised_vos_tpu_torch.models.zoo import auto_pretrained_path

        pretrained = auto_pretrained_path(model_name)
    net = build_train_net(model_name, dev, pretrained)
    optimizer = make_optimizer(net.parameters(), base_lr=lr)
    start_epoch = load_weights(resume, net, optimizer) if resume is not None else 0
    if freeze:
        trainable = net.frozen_backbone_mask()
        for name, param in net.named_parameters():
            param.requires_grad_(trainable[name])

    train_dataset = TrainDataset(Path(training) / "JPEGImages/480p", Path(training) / "Annotations/480p",
                                 cropping=crop, frame_num=frame_num, decode_cache=decode_cache)
    validation_dataset = TrainDataset(Path(validation) / "JPEGImages/480p", Path(validation) / "Annotations/480p",
                                      cropping=crop, frame_num=frame_num, decode_cache=decode_cache)
    validation_bs = max(bs // 2, 1)
    train_batches = math.ceil(len(train_dataset) / bs)
    save_model = Path(save_model)
    save_model.mkdir(parents=True, exist_ok=True)

    num_workers = default_num_workers()
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    mnet, eval_mesh = None, None
    if mesh is None:
        train_step = make_train_step(net, spec, optimizer, bf16=bf16)
        eval_step = make_eval_step(net, spec, bf16=bf16)
    else:
        from semi_supervised_vos_tpu_torch.parallel.mesh import Mesh
        from semi_supervised_vos_tpu_torch.parallel.tp import shard_tp
        from semi_supervised_vos_tpu_torch.parallel.train_mesh import (
            MeshNet,
            make_mesh_eval_step,
            make_mesh_train_step,
        )

        mnet = shard_tp(mesh, net, optimizer) if tp > 1 else MeshNet(mesh, net, optimizer)
        train_step = make_mesh_train_step(mnet, spec, bf16=bf16)
        # the epoch's validation is sharded when its batch divides over every
        # device; otherwise it runs unsharded: under --tp on the first data
        # row's columns, else on the one device
        if validation_bs % n_dev == 0:
            eval_mesh = mesh
        elif tp > 1:
            eval_mesh = Mesh([mesh.devices[0]])
        eval_step = (make_mesh_eval_step(mnet.on(eval_mesh), spec, bf16=bf16) if eval_mesh is not None
                     else make_eval_step(net, spec, bf16=bf16))
        logger.info(f"mesh: data={shape[0]} x model={tp} over {n_dev} devices")
    geometry_fn = make_geometry_fn(spec, davis_centroids(), dev)
    generator = torch.Generator(device=dev).manual_seed(42)

    def save(target):
        if mnet is not None:
            mnet.sync_to_net()  # the single-device layout of a checkpoint
        save_checkpoint(net, optimizer, epoch + 1, target)

    epoch = start_epoch
    early_stopper = EarlyStopping(save_model, log=logger.info, save_fn=save)
    progress, bar = None, None
    if not disable:
        try:
            from tqdm import tqdm

            bar = tqdm(total=epochs * train_batches, desc="Training.")
            progress = bar.update
        except ImportError:
            pass

    for epoch in range(start_epoch, start_epoch + epochs):
        # the reference reseeds the augmentation every epoch (train.py:132)
        train_dataset.seed(42)
        validation_dataset.seed(42)
        set_learning_rate(optimizer, cosine_lr(epoch, base_lr=lr, epochs=epochs))
        if mnet is not None and mnet.optimizer is not optimizer:  # the shards' optimizer
            set_learning_rate(mnet.optimizer, cosine_lr(epoch, base_lr=lr, epochs=epochs))
        net.train()
        train_loss = run_epoch(train_step, iterate_batches(train_dataset, bs, num_workers=num_workers), centroids,
                               generator, dev, progress=progress, geometry_fn=geometry_fn, mesh=mesh)
        validation_loss = float("nan")
        if epoch % 10 == 0:
            net.eval()
            validation_loss = run_epoch(
                eval_step, iterate_batches(validation_dataset, validation_bs, num_workers=num_workers), centroids,
                generator, dev, geometry_fn=geometry_fn, mesh=eval_mesh)
        if early_stop and early_stopper(validation_loss, epoch):
            logger.info("Early stopping stopped the training.")
            break
        save(save_model / checkpoint_name(epoch, train_loss, validation_loss))
        logger.info(f"epoch {epoch}: train_loss={train_loss:.5f} val_loss={validation_loss:.5f}")
    if bar:
        bar.close()
    if mnet is not None:
        mnet.sync_to_net()
    logger.info("Training finished.")
    return net
