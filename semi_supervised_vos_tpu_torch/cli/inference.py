"""`inference` command — the JAX package's CLI surface (reference
``src/inference.py:18-48``), on the PyTorch engine.

``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
card raises. All seven strategies run, in label and probability mode, one
video at a time or, with ``--video-batch`` > 1, that many videos in
lockstep (``infer/batched.py``), with any of the four ResNets (also as
multimodel's ``--additional-model-type``), ``dino_vitb8``, DINO's ViT-B/8
(``models/vit.py``: 768-wide features, ``--resume`` a DINO checkpoint or
one this port saved, ``--temperature`` 10 by default, DINO's 1 / 0.1), or
``sam2_hiera_l``, SAM 2.1's Hiera-L image encoder (``models/hiera.py``: the
256-wide stride-16 neck level of the 2× upsampled frame, ``--resume`` a
SAM 2 checkpoint or one this port saved, ``--temperature`` 10 by default).
Float32 features on the card are refused for both: their card paths run in
bfloat16 (and the 3xTF32 bank kernel stops at 256 channels).

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
encodes with the module instead of the BN-folded fast encoder (card only).

``SVOS_PROFILE=1`` records the port's spans and counters over the run
(``utils/profiling.py``: ``engine.step``, ``engine.upload``,
``engine.encode``, ``engine.propagate``, ``engine.write``, ``engine.start``,
``drain.queue``, ``drain.job``, ``drain.upsample``, ``cli.stack``,
``png.write``, ``data.decode``, the ViT's ``vit.embed``,
``vit.attention``, ``vit.mlp`` and Hiera's ``hiera.embed``,
``hiera.window_attention``, ``hiera.global_attention``, ``hiera.mlp``,
``hiera.neck``; ``upload.calls``, ``upload.bytes``,
``upload.pageable_bytes``, ``engine.frames``, ``lockstep.lane_steps``,
``lockstep.real_lane_steps``, ``data.frames``, ``vit.frames``,
``vit.tokens``, ``hiera.frames``, ``hiera.tokens``, ``hiera.windows``,
``affinity.sweeps``, ``affinity.splits``, ``affinity.wide_sweeps``)
and logs them once at the end as one ``phase timing | name: …s (nx, … ms
avg)`` line. ``SVOS_TRACE_DIR=<dir>`` writes a ``torch.profiler`` Chrome
trace of the run there, the mask drain's and PNG writers' spans included,
and logs the card's idle share from the first ``engine.step`` on with its
ten longest idle gaps, each named by the span the host was in.
"""

from __future__ import annotations

import os
from pathlib import Path

import click
import torch

from semi_supervised_vos_tpu_torch.utils.logging import logger

STRATEGIES = ["single", "hor-flip", "vert-flip", "2-scale", "multimodel", "hor-2-scale", "3-scale"]
INFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the temperature each network's features were scored at, where it is not 1
DEFAULT_TEMPERATURE = {"dino_vitb8": 10.0, "sam2_hiera_l": 10.0}


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
@click.option("--model", "-m", type=click.Choice(["resnet18", "resnet50", "resnet101", "facebook", "dino_vitb8",
                                                  "sam2_hiera_l"]),
              default="resnet50", help="Network architecture.")
@click.option("--temperature", "-t", type=float, default=None,
              help="Temperature parameter (default 1.0; 10.0 for dino_vitb8, the reciprocal of DINO's 0.1, and for "
                   "sam2_hiera_l).")
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
    from semi_supervised_vos_tpu_torch.utils.profiling import profiled_run

    try:
        with profiled_run():
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
    from semi_supervised_vos_tpu_torch.infer.engine import EngineConfig, float32_refusal
    from semi_supervised_vos_tpu_torch.models.convert import load_torch_checkpoint
    from semi_supervised_vos_tpu_torch.models.vos_net import VOSNet, build_vos_net
    from semi_supervised_vos_tpu_torch.utils.runtime import resolve_device

    dev = resolve_device(device)
    dtype = infer_dtype(dev)
    net = build_vos_net(model)
    if getattr(net, "card_path", False) and dev.type == "cuda" and dtype == torch.float32:
        raise click.UsageError(float32_refusal(model, net.feature_dim))
    if temperature is None:
        temperature = DEFAULT_TEMPERATURE.get(model, 1.0)
    mesh, mesh_dp = make_meshes(dev, video_batch, bank_shards, dp_shards)
    net = load_torch_checkpoint(resume, net)
    dataset = InferenceDataset(str(Path(data) / "JPEGImages/480p"), inference_strategy=inference_strategy, scale=scale)
    cfg = EngineConfig(
        ref_num=ref_num, frame_range=frame_range, temperature=temperature,
        sigma_1=sigma_1, sigma_2=sigma_2, probability_propagation=probability_propagation, compute_dtype=dtype,
        feature_dim=getattr(net, "feature_dim", 256),
    )
    progress = None
    if not disable:
        try:
            from tqdm import tqdm

            progress = tqdm(total=len(dataset)).update
        except ImportError:
            pass
    additional = None
    if inference_strategy == "multimodel":
        additional = load_torch_checkpoint(additional_resume, VOSNet(additional_model_type))
    args = (dataset, Path(data) / "Annotations/480p", save, net, cfg, dev)
    if video_batch > 1:
        from semi_supervised_vos_tpu_torch.infer import batched

        batched.inference_batched(*args, video_batch, inference_strategy, reduction, progress, mesh_dp,
                                  additional_model=additional, scale=scale)
    elif inference_strategy == "single":
        strategies.inference_single(*args, progress, mesh=mesh)
    else:
        strategies.inference(*args, inference_strategy, reduction, progress, mesh, additional_model=additional,
                             scale=scale)
    logger.info("Inference done.")
