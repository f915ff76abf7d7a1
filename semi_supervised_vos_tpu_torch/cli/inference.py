"""`inference` command — the JAX package's CLI surface (reference
``src/inference.py:18-48``), on the PyTorch engine.

``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
card raises. All seven strategies run, in label and probability mode, one
video at a time or, with ``--video-batch`` > 1, that many videos in
lockstep (``infer/batched.py``), with any of the four models (also as
multimodel's ``--additional-model-type``). Options this port does not have
yet raise a clear error: ``--bank-shards`` / ``--dp-shards`` > 1.
"""

from __future__ import annotations

from pathlib import Path

import click

from semi_supervised_vos_tpu_torch.utils.logging import logger

STRATEGIES = ["single", "hor-flip", "vert-flip", "2-scale", "multimodel", "hor-2-scale", "3-scale"]


@click.command(name="inference")
@click.option("--ref_num", "-n", type=int, default=9, help="Number of reference frames for inference.")
@click.option("--data", "-d", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to inference dataset folder.")
@click.option("--resume", "-r", type=click.Path(file_okay=True, dir_okay=True), required=True,
              help="Path to the trained checkpoint (.pth.tar file).")
@click.option("--model", "-m", type=click.Choice(["resnet18", "resnet50", "resnet101", "facebook"]),
              default="resnet50", help="Network architecture.")
@click.option("--temperature", "-t", type=float, default=1.0, help="Temperature parameter.")
@click.option("--frame_range", type=int, default=40, help="Range of frames for inference.")
@click.option("--sigma_1", type=float, default=8.0,
              help="Smaller sigma in the motion model for dense spatial weight.")
@click.option("--sigma_2", type=float, default=21.0,
              help="Larger sigma in the motion model for dense spatial weight.")
@click.option("--save", "-s", type=click.Path(file_okay=False, dir_okay=True), required=True,
              help="Path to save predictions.")
@click.option("--device", type=click.Choice(["cuda", "cpu"]), default="cuda",
              help="Device to run computing on.")
@click.option("--inference-strategy", type=click.Choice(STRATEGIES), default="single",
              help="Inference strategy.")
@click.option("--additional-model", type=click.Path(file_okay=True, dir_okay=True), required=False,
              help="Path to the additional checkpoint (multimodel).")
@click.option("--additional-model-type", type=click.STRING, required=False, default="resnet50",
              help="Type of additional model type (multimodel).")
@click.option("--probability/--no-probability", default=False, required=False,
              help="Should probability or labels be propagated.")
@click.option("--scale", default=1.15, required=False, type=click.FLOAT,
              help="Scale for 2nd image in 2-scale strategy.")
@click.option("--fusion", default="mean", type=click.Choice(["maximum", "minimum", "mean"]),
              help="Fusion operation for probability propagation.")
@click.option("--video-batch", type=int, default=1,
              help="Videos propagated in lockstep per group (1: one video at a time).")
@click.option("--bank-shards", type=int, default=1, help="Bank shards (only 1 is ported).")
@click.option("--dp-shards", type=int, default=1, help="Data-parallel shards (only 1 is ported).")
def inference_command(ref_num, data, resume, model, temperature, frame_range, sigma_1, sigma_2, save, device,
                      inference_strategy, additional_model, additional_model_type, probability, scale, fusion,
                      video_batch, bank_shards, dp_shards):
    try:
        inference_command_impl(
            ref_num, data, resume, model, temperature, frame_range, sigma_1, sigma_2, save, device,
            inference_strategy=inference_strategy, additional_resume=additional_model,
            additional_model_type=additional_model_type, probability_propagation=probability, scale=scale,
            reduction=fusion, video_batch=video_batch, bank_shards=bank_shards, dp_shards=dp_shards,
        )
    except (NotImplementedError, RuntimeError) as err:
        raise click.ClickException(str(err)) from err


def check_supported(inference_strategy, additional_resume, bank_shards, dp_shards) -> None:
    """Raise NotImplementedError for an option this port does not run yet, and
    a usage error for multimodel without its second checkpoint."""
    if bank_shards != 1 or dp_shards != 1:
        raise NotImplementedError("--bank-shards / --dp-shards > 1 (multi-device) are not ported")
    if inference_strategy == "multimodel" and additional_resume is None:
        raise click.UsageError("--inference-strategy multimodel needs --additional-model")


def inference_command_impl(ref_num, data, resume, model, temperature, frame_range, sigma_1, sigma_2, save,
                           device="cuda", inference_strategy="single", additional_resume=None,
                           additional_model_type="resnet50", probability_propagation=False, scale=1.15,
                           reduction="mean", video_batch=1, bank_shards=1, dp_shards=1, disable=False):
    """Reference ``src/inference.py:54-113``."""
    check_supported(inference_strategy, additional_resume, bank_shards, dp_shards)
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import strategies
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    net = load_torch_checkpoint(resume, VOSNet(model))
    dataset = InferenceDataset(str(Path(data) / "JPEGImages/480p"), inference_strategy=inference_strategy, scale=scale)
    cfg = EngineConfig(
        ref_num=ref_num, frame_range=frame_range, temperature=temperature,
        sigma_1=sigma_1, sigma_2=sigma_2, probability_propagation=probability_propagation,
    )
    progress = None
    if not disable:
        try:
            from tqdm import tqdm

            progress = tqdm(total=len(dataset)).update
        except ImportError:
            pass
    args = (dataset, Path(data) / "Annotations/480p", save, net)
    lockstep = video_batch > 1
    if lockstep:
        from semi_supervised_vos_tpu_torch.infer import batched
    if lockstep and inference_strategy == "multimodel":
        additional = load_torch_checkpoint(additional_resume, VOSNet(additional_model_type))
        batched.inference_multimodel_batched(*args, additional, cfg, dev, video_batch, reduction, progress)
    elif lockstep and inference_strategy == "3-scale":
        batched.inference_3_scale_batched(*args, cfg, dev, video_batch, scale, progress)
    elif lockstep and inference_strategy in ("2-scale", "hor-2-scale"):
        batched.inference_2_scale_batched(*args, cfg, dev, video_batch, inference_strategy == "hor-2-scale",
                                          reduction, progress)
    elif lockstep and inference_strategy in batched.BATCHABLE_STRATEGIES:
        batched.inference_batched(*args, cfg, dev, video_batch, inference_strategy, reduction, progress)
    elif inference_strategy == "single":
        strategies.inference_single(*args, cfg, dev, progress)
    elif inference_strategy == "hor-flip":
        strategies.inference_hor_flip(*args, cfg, dev, reduction, progress)
    elif inference_strategy == "vert-flip":
        strategies.inference_ver_flip(*args, cfg, dev, reduction, progress)
    elif inference_strategy in ("2-scale", "hor-2-scale"):
        strategies.inference_2_scale(*args, cfg, dev, scale, reduction, inference_strategy == "hor-2-scale", progress)
    elif inference_strategy == "multimodel":
        additional = load_torch_checkpoint(additional_resume, VOSNet(additional_model_type))
        strategies.inference_multimodel(*args, additional, cfg, dev, reduction, progress)
    elif inference_strategy == "3-scale":
        strategies.inference_3_scale(*args, cfg, dev, scale, progress)
    else:
        raise ValueError(f"unknown --inference-strategy {inference_strategy}")
    logger.info("Inference done.")
