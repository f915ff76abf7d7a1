"""Optimizer, learning-rate schedule and checkpoints (the port's
counterpart of the JAX package's ``train/train_state.py``).

SGD with Nesterov momentum 0.9 and weight decay 3e-4 coupled into the
gradient (reference ``src/train.py:75-81``), its learning rate set once an
epoch from a cosine down to 4e-5.

Checkpoints are the reference's ``.pth.tar`` (``train.py:144-151``):
``{"state_dict": ...}``, which the port's ``inference`` and ``validation``
and the JAX package's ``load_torch_checkpoint`` read, plus the optimizer
state and the epoch under ``"optimizer"`` and ``"epoch"``, so that
``--resume`` restores the whole train state as the JAX package's Orbax
resume does. A file with only a ``state_dict`` resumes the weights only.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch

from semi_supervised_vos_tpu_torch.models.convert import strip_module_prefix
from semi_supervised_vos_tpu_torch.utils.logging import logger


def cosine_lr(epoch, *, base_lr: float, epochs: int, eta_min: float = 4e-5) -> float:
    """torch ``CosineAnnealingLR(T_max=epochs, eta_min)`` in closed form."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def make_optimizer(params, base_lr: float = 0.02, momentum: float = 0.9, weight_decay: float = 3e-4,
                   nesterov: bool = True) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=base_lr, momentum=momentum, weight_decay=weight_decay, nesterov=nesterov)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def checkpoint_name(epoch: int, train_loss: float, val_loss: float) -> str:
    """The reference's file name (``train.py:144``)."""
    return "checkpoint-epoch-{:03d}-{:5f}-{:5f}.pth.tar".format(epoch, train_loss, val_loss)


def save_checkpoint(net: torch.nn.Module, optimizer: torch.optim.Optimizer, epoch: int, path) -> None:
    """The weights, the optimizer state and the next epoch to run."""
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in net.state_dict().items()},
                "optimizer": optimizer.state_dict(), "epoch": int(epoch)}, path)


def load_weights(path, net: torch.nn.Module, optimizer=None) -> int:
    """Restore a ``.pth.tar`` into ``net`` and, when the file has them,
    ``optimizer``; returns the epoch to start from (0 for weights only)."""
    path = Path(path)
    if path.is_dir():
        raise ValueError(f"{path} is a directory (a JAX package Orbax checkpoint?); "
                         "the port reads reference-format .pth.tar files only")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    net.load_state_dict(strip_module_prefix(sd))
    if optimizer is None or "optimizer" not in ckpt:
        logger.info(f"=> loaded weights from '{path}'")
        return 0
    optimizer.load_state_dict(ckpt["optimizer"])
    logger.info(f"=> resumed '{path}' at epoch {ckpt['epoch']}")
    return int(ckpt["epoch"])
