"""`validation` command (reference ``src/validation.py:29-98``): the
validation loss of every ``.pth.tar`` checkpoint in a directory, written as
a JSON report. A JAX package Orbax checkpoint (a ``.ckpt`` directory) is
refused with an error: the port cannot read it. With several devices (every
card under ``--device cuda``) the batch is sharded over all of them when it
divides, the JAX CLI's rule (``cli/validation.py:87-108`` there)."""

from __future__ import annotations

import json
from pathlib import Path

import click

from semi_supervised_vos_tpu_torch.cli.train import LOSS_CHOICES, MINER_CHOICES
from semi_supervised_vos_tpu_torch.utils.logging import logger


@click.command(name="validation")
@click.option("--data", "-d", type=click.Path(file_okay=False, dir_okay=True), required=True, help="Path to dataset.")
@click.option("--checkpoints", "-c", type=click.Path(dir_okay=True, file_okay=False), help="Path to checkpoints.")
@click.option("--bs", type=int, default=16, help="Batch size.")
@click.option("--loss", type=click.Choice(LOSS_CHOICES), default="cross_entropy", help="Loss function to use.")
@click.option("--miner", type=click.Choice(MINER_CHOICES), default="default", help="Triplet loss miner.")
@click.option("--margin", type=click.FloatRange(min=0.0, max=1.0), default=0.1, help="Triplet loss margin.")
@click.option("--loss_weight", type=click.FloatRange(min=0.0), default=6.0, help="Weight of triplet loss.")
@click.option("--output", "-o", type=click.Path(dir_okay=False, file_okay=True), help="Path to output JSON.")
@click.option("--model", "model_name", type=click.Choice(["resnet18", "resnet50", "resnet101"]),
              default="resnet50", help="Backbone.")
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda", help="Device to run computing on.")
def validation_command(data, checkpoints, bs, loss, miner, margin, loss_weight, output, model_name, device):
    try:
        validation_command_impl(data, checkpoints, bs, loss, miner, margin, loss_weight, output, model_name, device)
    except (NotImplementedError, RuntimeError, ValueError) as err:
        raise click.ClickException(str(err)) from err


def validation_command_impl(data, checkpoints, bs, loss, miner, margin, loss_weight, output, model_name="resnet50",
                            device="cuda", disable=False, frame_num=10, crop=256, devices=None):
    """Reference ``src/validation.py:29-98``; returns {checkpoint name: loss}.
    ``devices``: the mesh's devices in place of every card (or the CPU)."""
    import torch

    from semi_supervised_vos_tpu_torch.cli.train import make_spec, mesh_devices

    from semi_supervised_vos_tpu_torch.config import default_num_workers
    from semi_supervised_vos_tpu_torch.data.davis import TrainDataset
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.ops.onehot import davis_centroids
    from semi_supervised_vos_tpu_torch.train.loop import iterate_batches, make_eval_step, make_geometry_fn, run_epoch
    from semi_supervised_vos_tpu_torch.train.train_state import load_weights
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    devices = mesh_devices(dev, devices)
    n_dev = len(devices)
    mesh = None
    if n_dev > 1 and bs % n_dev == 0:
        from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_dev, 1, devices=devices)
        logger.info(f"mesh: data={n_dev} over {n_dev} devices")
    elif n_dev > 1:
        logger.warning(f"batch size {bs} does not divide over {n_dev} devices; "
                       "running single-device (pick a divisible --bs to engage the mesh)")
    dev = devices[0]
    logger.info("Validation started.")
    spec = make_spec(loss, miner, margin, loss_weight)
    ckpts = sorted(p for p in Path(checkpoints).iterdir() if p.suffix == ".ckpt" or p.name.endswith(".pth.tar"))
    orbax = [p.name for p in ckpts if p.is_dir()]
    if orbax:
        raise ValueError(f"{', '.join(orbax)}: JAX package Orbax checkpoints; the port reads .pth.tar files only")
    validation_dataset = TrainDataset(Path(data) / "JPEGImages/480p", Path(data) / "Annotations/480p",
                                      cropping=crop, frame_num=frame_num)
    net = VOSNet(model_name).to(dev)
    if dev.type == "cuda":
        net = net.to(memory_format=torch.channels_last)
    net.eval()
    if mesh is None:
        eval_step = make_eval_step(net, spec)
    else:
        from semi_supervised_vos_tpu_torch.parallel.train_mesh import MeshNet, make_mesh_eval_step

        eval_step = make_mesh_eval_step(MeshNet(mesh, net), spec)
    centroids = torch.as_tensor(davis_centroids(), dtype=torch.float32, device=dev)
    geometry_fn = make_geometry_fn(spec, davis_centroids(), dev)
    generator = torch.Generator(device=dev).manual_seed(42)

    losses_out = {}
    for ckpt in ckpts:
        load_weights(ckpt, net)
        validation_dataset.seed(42)
        # items do not depend on the decode threads (TrainDataset.plan)
        val_loss = run_epoch(eval_step, iterate_batches(validation_dataset, bs, num_workers=default_num_workers()),
                             centroids, generator, dev, geometry_fn=geometry_fn, mesh=mesh)
        losses_out[ckpt.name] = val_loss
        logger.info(f"{ckpt.name}: {val_loss:.5f}")
    if output is not None:
        with Path(output).open(mode="w") as writer:
            json.dump(losses_out, writer)
    logger.info("Validation finished.")
    return losses_out
