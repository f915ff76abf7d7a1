"""`inference` command — the JAX package's CLI surface (reference
``src/inference.py:18-48``), on the PyTorch engine.

``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
card raises. All seven strategies run, in label and probability mode, one
video at a time or, with ``--video-batch`` > 1, that many videos in
lockstep (``infer/batched.py``), with any of the four models (also as
multimodel's ``--additional-model-type``).

Two multi-device axes, as in the JAX CLI, composable under
``--video-batch``: ``--bank-shards`` shards each stream's bank pixel rows
(one video at a time: ``parallel/engine_sharded.py``), ``--dp-shards``
spreads lockstep video lanes (``parallel/batched_dp.py``); with
``--video-batch`` > 1 they form the 2-D mesh. One process drives every
device (``parallel/mesh.py``). On the card ``--dp-shards x --bank-shards``
may not exceed ``torch.cuda.device_count()``; with ``--device cpu`` the mesh
is virtual (the CPU named that many times), so there is no count to exceed.

``SVOS_INFER_DTYPE`` (``float32`` or ``bfloat16``; the JAX CLI's default:
bf16 on the card, float32 on the CPU) sets the features' dtype: on the card
float32 runs the float32 variants of both kernels. ``SVOS_FAST_ENCODER=0``
encodes with the module instead of the BN-folded fast encoder (card only),
``SVOS_PROFILE=1`` logs per-phase timing and ``SVOS_TRACE_DIR`` writes a
``torch.profiler`` trace (``infer/strategies.py::run_streams``).
"""

from __future__ import annotations

import os
from pathlib import Path

import click
import torch

from semi_supervised_vos_tpu_torch.utils.logging import logger

STRATEGIES = ["single", "hor-flip", "vert-flip", "2-scale", "multimodel", "hor-2-scale", "3-scale"]
INFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def infer_dtype(dev: torch.device) -> torch.dtype:
    """The engines' compute dtype from ``SVOS_INFER_DTYPE`` (JAX
    ``cli/inference.py:106-116``): ``bfloat16`` on the card and ``float32``
    on the CPU unless set; another value is a usage error."""
    name = os.environ.get("SVOS_INFER_DTYPE", "bfloat16" if dev.type == "cuda" else "float32")
    if name not in INFER_DTYPES:
        raise click.UsageError(f"SVOS_INFER_DTYPE must be float32 or bfloat16, got {name!r}")
    return INFER_DTYPES[name]


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
@click.option("--bank-shards", type=int, default=1,
              help="Shard each stream's memory-bank pixel rows over this many devices (the mesh's 'model' "
                   "axis); composes with every strategy and with --video-batch. On the card at most "
                   "torch.cuda.device_count() together with --dp-shards; with --device cpu the devices are "
                   "virtual (the CPU repeated).")
@click.option("--dp-shards", type=int, default=1,
              help="Shard --video-batch lanes over this many devices (data-parallel lockstep inference; the "
                   "mesh's 'data' axis). Requires --video-batch > 1. Counted against the cards as "
                   "--bank-shards is.")
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


def check_supported(inference_strategy, additional_resume) -> None:
    """A usage error for multimodel without its second checkpoint."""
    if inference_strategy == "multimodel" and additional_resume is None:
        raise click.UsageError("--inference-strategy multimodel needs --additional-model")


def make_meshes(dev, video_batch: int, bank_shards: int, dp_shards: int):
    """The JAX CLI's rules (``cli/inference.py:145-168``, same messages):
    (mesh for one video at a time, lockstep mesh), either None. On the card
    the mesh takes the first ``dp_shards x bank_shards`` cards; on the CPU
    it is virtual, the CPU repeated."""
    if dp_shards < 1 or bank_shards < 1:
        raise click.ClickException("--dp-shards and --bank-shards must be >= 1.")
    if dp_shards > 1 and video_batch <= 1:
        raise click.ClickException(
            "--dp-shards requires --video-batch > 1 (it shards lockstep video lanes over chips)."
        )
    n = dp_shards * bank_shards
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise click.ClickException(
            f"--dp-shards {dp_shards} x --bank-shards {bank_shards} exceeds "
            f"the {torch.cuda.device_count()} available device(s)."
        )
    if n == 1:
        return None, None
    from semi_supervised_vos_tpu_torch.parallel.mesh import make_mesh

    devices = [dev] * n if dev.type == "cpu" else None
    if video_batch > 1:
        return None, make_mesh(n_data=dp_shards, n_model=bank_shards, devices=devices)
    return make_mesh(n_data=1, n_model=bank_shards, devices=devices), None


def inference_command_impl(ref_num, data, resume, model, temperature, frame_range, sigma_1, sigma_2, save,
                           device="cuda", inference_strategy="single", additional_resume=None,
                           additional_model_type="resnet50", probability_propagation=False, scale=1.15,
                           reduction="mean", video_batch=1, bank_shards=1, dp_shards=1, disable=False):
    """Reference ``src/inference.py:54-113``."""
    check_supported(inference_strategy, additional_resume)
    from semi_supervised_vos_tpu_torch.data.davis import InferenceDataset
    from semi_supervised_vos_tpu_torch.infer import strategies
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    dtype = infer_dtype(dev)
    mesh, mesh_dp = make_meshes(dev, video_batch, bank_shards, dp_shards)
    net = load_torch_checkpoint(resume, VOSNet(model))
    dataset = InferenceDataset(str(Path(data) / "JPEGImages/480p"), inference_strategy=inference_strategy, scale=scale)
    cfg = EngineConfig(
        ref_num=ref_num, frame_range=frame_range, temperature=temperature,
        sigma_1=sigma_1, sigma_2=sigma_2, probability_propagation=probability_propagation, compute_dtype=dtype,
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
        batched.inference_multimodel_batched(*args, additional, cfg, dev, video_batch, reduction, progress,
                                             mesh=mesh_dp)
    elif lockstep and inference_strategy == "3-scale":
        batched.inference_3_scale_batched(*args, cfg, dev, video_batch, scale, progress, mesh=mesh_dp)
    elif lockstep and inference_strategy in ("2-scale", "hor-2-scale"):
        batched.inference_2_scale_batched(*args, cfg, dev, video_batch, inference_strategy == "hor-2-scale",
                                          reduction, progress, mesh=mesh_dp)
    elif lockstep and inference_strategy in batched.BATCHABLE_STRATEGIES:
        batched.inference_batched(*args, cfg, dev, video_batch, inference_strategy, reduction, progress,
                                  mesh=mesh_dp)
    elif inference_strategy == "single":
        strategies.inference_single(*args, cfg, dev, progress, mesh=mesh)
    elif inference_strategy == "hor-flip":
        strategies.inference_hor_flip(*args, cfg, dev, reduction, progress, mesh=mesh)
    elif inference_strategy == "vert-flip":
        strategies.inference_ver_flip(*args, cfg, dev, reduction, progress, mesh=mesh)
    elif inference_strategy in ("2-scale", "hor-2-scale"):
        strategies.inference_2_scale(*args, cfg, dev, scale, reduction, inference_strategy == "hor-2-scale", progress,
                                     mesh=mesh)
    elif inference_strategy == "multimodel":
        additional = load_torch_checkpoint(additional_resume, VOSNet(additional_model_type))
        strategies.inference_multimodel(*args, additional, cfg, dev, reduction, progress, mesh=mesh)
    elif inference_strategy == "3-scale":
        strategies.inference_3_scale(*args, cfg, dev, scale, progress, mesh=mesh)
    else:
        raise ValueError(f"unknown --inference-strategy {inference_strategy}")
    logger.info("Inference done.")
