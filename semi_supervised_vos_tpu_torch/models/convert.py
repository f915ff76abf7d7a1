"""Checkpoint IO for the torch VOSNet.

* :func:`load_torch_checkpoint` reads a reference ``.pth.tar`` (a dict with
  ``state_dict``, reference ``src/train.py:146-151``, or a bare state dict)
  straight into the module; ``module.`` prefixes left by
  ``torch.nn.DataParallel`` are stripped (``src/utils/utils.py:88-94``).
  A DINO checkpoint (``models/vit.py``; its ``teacher`` / ``student``
  entry, ``backbone.`` prefixes, the ``head.*`` projection) loads into a
  ``DinoViT`` through :func:`dino_state_dict`; a SAM 2 checkpoint
  (``models/hiera.py``; its ``model`` entry, the ``image_encoder.trunk.*``
  and ``image_encoder.neck.*`` keys) into a ``SamHiera`` through
  :func:`sam2_state_dict`.
* :func:`save_torch_checkpoint` writes the same format.
* :func:`load_torchvision_backbone` initialises the backbone from a
  torchvision ImageNet ResNet checkpoint, dropping ``layer4.*`` and ``fc.*``
  as the reference does (``resnet.py:194-199``: layer4's shapes differ in
  the VOS topology, so it keeps its fresh initialisation, as the head does).
  ``facebook`` keeps layer4, whose shapes are torchvision's, and drops only
  ``fc.*``, as the reference loads the whole swsl checkpoint
  (``vos_net.py:29-38``).
* :func:`state_dict_from_jax` carries weights across from the JAX package:
  flax variables (as numpy) → this module's state dict, for a VOSNet or a
  bare backbone (:class:`~.resnet.ResNet`, the JAX ``ResNetBackbone``, any
  of the six layouts). It inverts the JAX package's
  ``convert_vosnet_state_dict``: HWIO kernels become OIHW, and BN
  ``scale/bias`` params with ``mean/var`` batch stats become
  ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from semi_supervised_vos_tpu_torch.models.vos_net import HIERA_NAMES, VIT_NAMES
from semi_supervised_vos_tpu_torch.utils.logging import logger

_BN_FIELDS = {
    "weight": ("params", "scale"),
    "bias": ("params", "bias"),
    "running_mean": ("batch_stats", "mean"),
    "running_var": ("batch_stats", "var"),
}


def strip_module_prefix(sd: Mapping) -> Dict:
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_torch_checkpoint(path, net: torch.nn.Module) -> torch.nn.Module:
    """Load a reference ``.pth.tar`` / ``.pth`` into ``net`` (strict keys).
    A missing file logs and exits -1, as the reference does
    (``utils.py:83-85``)."""
    if not os.path.isfile(path):
        logger.info(f"=> no checkpoint found at '{path}'")
        sys.exit(-1)
    logger.info(f"=> loading checkpoint '{path}'")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = getattr(net, "model", None)
    if model in VIT_NAMES or model in HIERA_NAMES:
        net.load_state_dict((dino_state_dict if model in VIT_NAMES else sam2_state_dict)(ckpt, net))
        logger.info(f"=> loaded checkpoint '{path}'")
        return net
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    net.load_state_dict(strip_module_prefix(ckpt))
    logger.info(f"=> loaded checkpoint '{path}'")
    return net


def dino_state_dict(sd: Mapping, net: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A state dict in DINO's checkpoint layout → :class:`~.vit.DinoViT`'s: the
    ``teacher`` (else ``student``, else ``state_dict``) entry of a training
    checkpoint, ``module.`` and ``backbone.`` prefixes stripped and the
    ``head.*`` projection (not part of the backbone) dropped; with ``net``,
    every key and shape is checked against it."""
    for entry in ("teacher", "student", "state_dict", "model"):
        if isinstance(sd, dict) and entry in sd and isinstance(sd[entry], dict):
            sd = sd[entry]
            break
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "backbone."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("head."):
            continue
        out[k] = v
    return _checked(out, net)


def sam2_state_dict(sd: Mapping, net: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """A state dict in SAM 2's checkpoint layout → :class:`~.hiera.SamHiera`'s:
    the ``model`` (else ``state_dict``) entry, ``module.`` and
    ``image_encoder.`` prefixes stripped, the image encoder's trunk and the
    neck's stage-4 and stage-3 laterals (``neck.convs.0`` / ``.1``) kept, and
    everything else dropped: the neck's stride-8 and stride-4 laterals
    (``neck.convs.2`` / ``.3``, which feed only SAM 2's mask decoder) and the
    memory, prompt and mask-decoder modules. A checkpoint this port saved
    (the module's own keys) loads the same way. With ``net``, every key and
    shape is checked against it."""
    for entry in ("model", "state_dict"):
        if isinstance(sd, dict) and entry in sd and isinstance(sd[entry], dict):
            sd = sd[entry]
            break
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "image_encoder."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.startswith("trunk.") or k.startswith(("neck.convs.0.", "neck.convs.1.")):
            out[k] = v
    return _checked(out, net)


def _checked(out: Dict[str, torch.Tensor], net: Optional[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """``out``, once its keys and shapes are ``net``'s (no check without
    ``net``)."""
    if net is not None:
        ours = net.state_dict()
        missing, extra = sorted(set(ours) - set(out)), sorted(set(out) - set(ours))
        bad = [k for k in ours if k in out and tuple(out[k].shape) != tuple(ours[k].shape)]
        if missing or extra or bad:
            raise ValueError(f"not a {net.model} state dict: missing {missing[:4]}, unexpected {extra[:4]}, "
                             f"shapes differ at {bad[:4]}")
    return out


def save_torch_checkpoint(net: torch.nn.Module, path) -> None:
    """Write ``{"state_dict": ...}`` as the reference trainer does."""
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    torch.save({"state_dict": sd}, path)


def load_torchvision_backbone(net: torch.nn.Module, state_dict: Mapping) -> torch.nn.Module:
    """Copy a torchvision ResNet state dict (``conv1``, ``bn1``,
    ``layer1..3``, and ``layer4`` for facebook) into ``net.backbone``
    (``backbone.0``, ``backbone.1``, ``backbone.4..7``); ``fc.*`` and, but
    for facebook, ``layer4.*`` are dropped. Every kept key must exist in
    ``net`` with the same shape."""
    target = net.state_dict()
    seq = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6", "layer4": "7"}
    dropped = ("fc",) if getattr(net, "model", None) == "facebook" else ("fc", "layer4")
    merged = {}
    for key, value in strip_module_prefix(state_dict).items():
        head, rest = key.split(".", 1)
        if head in dropped:
            continue
        ours = f"backbone.{seq[head]}.{rest}"
        if ours not in target or target[ours].shape != value.shape:
            raise ValueError(f"{key}: no parameter {ours} of shape {tuple(value.shape)} in {type(net).__name__}")
        merged[ours] = value
    net.load_state_dict(merged, strict=False)
    return net


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _block_path(stage: int, block: str, rest) -> Tuple[str, ...]:
    if rest[0] == "downsample":
        rest = ["downsample_conv" if rest[1] == "0" else "downsample_bn"]
    return (f"layer{stage}_{block}", *rest)


def _jax_module_path(module_key: str) -> Tuple[str, ...]:
    """Torch module path → flax module path: VOSNet's
    ``backbone.5.0.downsample.1`` → ``backbone/layer2_0/downsample_bn``, a
    bare backbone's ``layer2.0.downsample.1`` → ``layer2_0/downsample_bn``."""
    parts = module_key.split(".")
    if parts[0] in ("conv1", "bn1"):  # a bare backbone's stem
        return (parts[0],)
    if parts[0].startswith("layer"):  # and its stages
        return _block_path(int(parts[0][len("layer"):]), parts[1], parts[2:])
    if parts[0] != "backbone":
        return ("_".join(parts),)  # adjust_dim, facebook's adjust_dim.0 / .1 (adjust_dim_0 / _1), bn256
    if parts[1] == "0":
        return ("backbone", "conv1")
    if parts[1] == "1":
        return ("backbone", "bn1")
    return ("backbone", *_block_path(int(parts[1]) - 3, parts[2], parts[3:]))


def state_dict_from_jax(variables: Mapping, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables (``{"params", "batch_stats"}``, numpy
    or array leaves) → a state dict for ``model`` (same architecture)."""
    trees = {
        "params": _flatten(variables["params"]),
        "batch_stats": _flatten(variables["batch_stats"]),
    }
    modules = dict(model.named_modules())
    sd = {}
    for key, ref in model.state_dict().items():
        module_key, field = key.rsplit(".", 1)
        path = _jax_module_path(module_key)
        if isinstance(modules[module_key], torch.nn.Conv2d):
            kernel = trees["params"][path + ("conv", "kernel")]  # HWIO
            value = kernel.transpose(3, 2, 0, 1)
        elif field == "num_batches_tracked":
            value = np.zeros((), np.int64)
        else:
            tree, leaf = _BN_FIELDS[field]
            value = trees[tree][path + (leaf,)]
        t = torch.as_tensor(np.array(value)).to(ref.dtype)
        if t.shape != ref.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
        sd[key] = t
    return sd

